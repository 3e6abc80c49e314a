"""Readings for the limits that decide ``correct`` (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--systems K]

For each seed of ``--seeds`` it draws the cell's inputs, runs the timed
path's own call on each input set (after the same warm-up as a run) and
prints the numbers the run would compare; for each seed of
``--control-seeds`` it prints the same numbers for the control: the plain
reference at TF32 put in the program's place.  One JSON line each.  On the
card this is how each limit's lower and upper readings are taken, at the
cell's own size; ``--systems`` shrinks the traffic (the tests run it on
the CPU).
"""
import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(cell, seed, device, control):
    import torch

    entry = cell.entry_module().make(cell.config, cell.traffic, seed, torch.device(device))
    ref = cell.reference()
    worst = {}
    t0 = time.perf_counter()
    for s in range(len(entry.sets)):
        if control:
            out = ref.control(cell.config, cell.traffic, entry.sets[s])
        else:
            entry.call(s)  # the warm-up call a run makes
            out = entry.call(s)
        for key, v in ref.judge(cell.config, cell.traffic, entry.sets[s], out).items():
            v = v if v == v else float("inf")
            worst[key] = max(v, worst.get(key, 0.0))
        del out
    del entry
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return worst, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--systems", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import harness

    cell = harness.Cell(args.workload)
    if args.systems is not None:
        cell.traffic = dict(cell.traffic, systems=args.systems)
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            worst, sec = readings(cell, seed, args.device, kind == "control")
            print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                              "systems": cell.traffic["systems"], "seconds": sec,
                              "readings": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
