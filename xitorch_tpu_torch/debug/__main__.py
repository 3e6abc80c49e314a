"""Run a python script under the port's debug mode:

    python -m xitorch_tpu_torch.debug script.py [args...]

(counterpart of xitorch_tpu/debug/__main__.py).
"""
import argparse
import runpy
import sys

from xitorch_tpu_torch.debug.modes import set_debug_mode


def main():
    parser = argparse.ArgumentParser(
        description="Running python script in debug mode of xitorch_tpu_torch")
    parser.add_argument("script", type=str, help="The python script to run")
    parser.add_argument("args", nargs=argparse.REMAINDER,
                        help="Arguments for the script")
    args = parser.parse_args()

    set_debug_mode(True)
    sys.argv = [args.script] + list(args.args)
    runpy.run_path(args.script, run_name="__main__")


if __name__ == "__main__":
    main()
