"""CPU tests of the benchmark harness (``python -m pytest portbench/tests -q``).

They run the harness on the CPU at a tiny size, through the port's plain
CPU routes; the test marked ``cuda`` needs the card and skips without it.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

CELLS = ["tlr_cg_fwd", "tlr_cg_grad", "tlr_thomas_fwd", "spd_exacteig_fwd"]
# systems a call on the CPU: the configurations' widths, a tiny batch
TINY = {"tlr_cg_fwd": 16, "tlr_cg_grad": 8, "tlr_thomas_fwd": 16, "spd_exacteig_fwd": 2}


def tiny_cell(name):
    cell = harness.Cell(name)
    cell.traffic = dict(cell.traffic, systems=TINY[name])
    return cell


def cpu_run(cell, trace=False, seconds=0.2):
    torch.set_num_threads(2)
    return harness.run(cell, 2 ** 31 + 7, seconds, trace, time.perf_counter(), device="cpu")


def test_benchmark_json_names_every_file():
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for conf in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, conf["file"]))
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"])
        assert os.path.isfile(os.path.join(PB, "entries", cell.traffic["entry"] + ".py"))
        assert os.path.isfile(os.path.join(PB, "reference", cell.config["reference"] + ".py"))
        assert set(cell.limits) and all(v["limit"] is not None for v in cell.limits.values())
        for k in cell.entry_module().make(cell.config, dict(cell.traffic, systems=1), 1,
                                          torch.device("cpu")).kernels:
            assert harness.roofline(k).NAME_PART
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(PB, "metrics", m["name"] + ".py"))


def test_added_files_are_found_by_name(tmp_path):
    """A new traffic mix, configuration, cell and per-layer metric, added as
    files and entries to a copy of the benchmark, are loaded by name with no
    file of the harness edited."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out", "tests"))
    pb = tmp_path / "portbench"
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = harness.load_json(os.path.join(PB, "configs", "tridiag_lowrank_n1024.json"))
    cfg["name"] = "tridiag_lowrank_n512"
    cfg["n"] = 512
    (pb / "configs" / "tridiag_lowrank_n512.json").write_text(json.dumps(cfg))
    traffic = harness.load_json(os.path.join(PB, "traffic", "lines_262144_fwd.json"))
    traffic["systems"] = 4
    (pb / "traffic" / "lines_4_fwd.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tlr_cg_fwd_small.json").write_text(json.dumps({"x_err": {"limit": 1e-3}}))
    (pb / "metrics" / "systems_per_call.py").write_text(
        "def read(obs):\n    return float(obs.entry.systems)\n")
    bench["configs"].append({"name": "tridiag_lowrank_n512", "source": "a test",
                             "file": "portbench/configs/tridiag_lowrank_n512.json",
                             "reduced": ["n"], "why": "a test"})
    bench["workloads"].append({"name": "tlr_cg_fwd_small", "config": "tridiag_lowrank_n512",
                               "traffic": "lines_4_fwd", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "systems_per_call", "unit": "systems", "better": "higher",
                               "source": "program_counter", "layer": "Public API",
                               "moves": "systems_per_s", "workloads": ["tlr_cg_fwd_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys, time, json\n"
        "sys.path[:0] = [%r, %r]\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from portbench import harness\n"
        "assert harness.HERE == %r, harness.HERE\n"
        "cell = harness.Cell('tlr_cg_fwd_small')\n"
        "rc, res = harness.run(cell, 5, 0.1, True, time.perf_counter(), device='cpu')\n"
        "print(json.dumps([rc, res, cell.config['n']]))\n" % (str(tmp_path), ROOT, str(pb)))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    rc, res, n = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and n == 512 and res["correct"] is True
    assert res["metrics"]["systems_per_call"]["value"] == 4.0


def test_roofline_arithmetic_matches_hand_counts():
    """Rows 1 and 2 at config 3's published K = 512, counting the bytes the
    function needs (d, V, b in and x out; d, b in and x out; the coupling a
    scalar): 0.0044 ms and 0.0019 ms; row 3 from the frozen counts, 0.72 ms
    at config 2's 64 matrices (the table's 0.7186 came from one run's
    kernel counts)."""
    pk = harness.peaks()
    cfg3 = harness.load_json(os.path.join(PB, "configs", "tridiag_lowrank_n1024.json"))
    cfg2 = harness.load_json(os.path.join(PB, "configs", "dense_spd_n256.json"))
    t1, by1 = harness.roofline("structured_cg").least_seconds(cfg3, {"systems": 512}, pk)
    t2, by2 = harness.roofline("thomas").least_seconds(cfg3, {"systems": 512}, pk)
    assert by1 == by2 == "bytes"
    assert t1 == pytest.approx(7 * 512 * 1024 * 4 / 3.35e12) and round(t1 * 1e3, 4) == 0.0044
    assert t2 == pytest.approx(3 * 512 * 1024 * 4 / 3.35e12) and round(t2 * 1e3, 4) == 0.0019
    counts = harness.load_json(os.path.join(PB, "rooflines", "jacobi_sweep.dense_spd_n256.json"))
    t3, by3 = harness.roofline("jacobi_sweep").least_seconds(cfg2, {"systems": 1024}, pk)
    rounds = 258  # 255 rounds of the ring, in groups of 6
    flops = (counts["sweeps_total"] * rounds * 128 * 2 * 256 + counts["rotations_total"] * 8 * 256
             + (counts["sweeps_total"] + 1024) * (256 * 255 // 2 + 256) * 2 * 256)
    assert counts["batch"] == 1024
    assert by3 == "operations" and t3 == pytest.approx(flops / 67e12)
    t64, _ = harness.roofline("jacobi_sweep").least_seconds(cfg2, {"systems": 64}, pk)
    assert t64 == pytest.approx(t3 / 16, rel=0.01) and 0.70e-3 < t64 < 0.74e-3


class _Stalling:
    """A stand-in entry: each call takes 20 ms, one call 400 ms."""

    systems = 10
    sets = [{}, {}]
    kernels = []

    def __init__(self):
        self.n = 0

    def call(self, s):
        self.n += 1
        time.sleep(0.4 if self.n == 5 else 0.02)
        return {}

    def launches(self):
        return 2 * self.n


def test_rate_and_tail_are_taken_over_every_call_with_a_stall():
    entry, keep = _Stalling(), {}
    w = harness.run_window(torch, entry, 1.0, keep, 0, cuda=False)
    assert w.calls == entry.n and len(w.latency_ms) == w.calls
    # the rate counts the stall's time: every call over the whole window
    rate = w.calls * entry.systems / w.window_s
    assert w.window_s >= 0.4 + 0.02 * (w.calls - 1)
    assert rate < entry.systems / 0.02 * 0.75
    # the p95 of all calls, the stall included: with ~30 calls the stall is
    # the largest value and the 95th percentile lies below it, above the rest
    lat = sorted(w.latency_ms)
    assert lat[-1] >= 400
    q = harness.p95(w.latency_ms)
    k = 0.95 * (len(lat) - 1)
    lo = int(k)
    assert q == pytest.approx(lat[lo] + (lat[min(lo + 1, len(lat) - 1)] - lat[lo]) * (k - lo))
    assert w.launches == 2 * w.calls


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


def test_no_module_imports_jax_and_the_reference_imports_no_port():
    """Top-level names compared whole: ``xitorch_tpu_torch`` begins with
    ``xitorch_tpu`` and is allowed outside ``reference/``."""
    files = []
    for d, _, fs in os.walk(PB):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        names = _imports(path)
        assert not names & {"jax", "jaxlib", "flax", "xitorch_tpu"}, (path, names)
        if os.sep + "reference" + os.sep in path:
            assert not names & {"xitorch_tpu_torch", "xitorch_tpu"}, (path, names)
            assert names <= {"torch", "contextlib", "portbench", "math"}, (path, names)


def test_run_refuses_jax_in_the_process(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc, res = cpu_run(tiny_cell("tlr_thomas_fwd"))
    assert rc == 3 and res is None


def test_command_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(PB, "run.py"), "--workload",
                          "tlr_thomas_fwd", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_cpu(name, trace):
    """Each reference against the port's plain CPU route at a tiny size,
    through the whole run, under the cell's own limits."""
    rc, res = cpu_run(tiny_cell(name), trace)
    assert rc == 0 and res["correct"] is True, res
    assert list(res)[-1] == "checks"
    key = "host_issue_ms" if trace else "systems_per_s"
    assert res["metrics"][key]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name):
    """The control, the reference at TF32 put in the program's place, fails
    the cell's limits (on the card: at the cell's own size, PERF.md)."""
    cell = tiny_cell(name)
    entry = cell.entry_module().make(cell.config, cell.traffic, 3, torch.device("cpu"))
    ref = cell.reference()
    keep = {s: ref.control(cell.config, cell.traffic, entry.sets[s])
            for s in range(len(entry.sets))}
    correct, checks = harness.judge(cell, entry, keep)
    assert not correct, checks


def _half_left_out(out):
    """Half of the systems' answers left out (zero), the rest kept; the
    gradient still flows through what is kept."""
    for k, t in out.items():
        keep = torch.ones_like(t)
        keep[t.shape[0] // 2:] = 0
        out[k] = t * keep
    return out


def _one_altered(out):
    """One number of the first output altered where it is produced."""
    k = sorted(out)[0]
    t = out[k]
    bump = torch.zeros_like(t)
    bump.view(-1)[t.numel() // 3] = 1e-2 * float(t.detach().abs().max())
    out[k] = t + bump
    return out


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_half_left_out, _one_altered])
def test_a_fault_under_the_timed_path_comes_out_not_correct(monkeypatch, name, fault):
    """The run with the public entry broken underneath it (half of the
    systems' answers left out; one answer altered where it is produced)."""
    import xitorch_tpu_torch as xt

    if name == "spd_exacteig_fwd":
        real = xt.linalg.symeig

        def broken(*a, **k):
            evals, evecs = real(*a, **k)
            out = fault({"evals": evals, "evecs": evecs})
            return out["evals"], out["evecs"]

        monkeypatch.setattr(xt.linalg, "symeig", broken)
    else:
        real = xt.linalg.solve

        def broken(*a, **k):
            return fault({"x": real(*a, **k)})["x"]

        monkeypatch.setattr(xt.linalg, "solve", broken)
    rc, res = cpu_run(tiny_cell(name))
    assert rc == 0 and res["correct"] is False, res


def _duplicated(X):
    """The second eigenvector returned as a copy of the first."""
    X = X.clone()
    X[..., 1] = X[..., 0]
    return X


def _neighbours_mixed(X):
    """The second eigenvector replaced by its sum with the first, normalised:
    its residual stays under the limit, as the two eigenvalues lie close."""
    X = X.clone()
    X[..., 1] = (X[..., 0] + X[..., 1]) / 2 ** 0.5
    return X


@pytest.mark.parametrize("fault", [_duplicated, _neighbours_mixed])
def test_a_wrong_eigenvector_block_comes_out_not_correct(monkeypatch, fault):
    """Config 2's run with symeig's eigenvectors broken where they are
    produced: a vector returned twice, or two neighbours mixed, fails the
    block's orthonormality (``orth``) while each vector's residual holds."""
    import xitorch_tpu_torch as xt

    real = xt.linalg.symeig

    def broken(*a, **k):
        evals, evecs = real(*a, **k)
        return evals, fault(evecs)

    monkeypatch.setattr(xt.linalg, "symeig", broken)
    cell = tiny_cell("spd_exacteig_fwd")
    rc, res = cpu_run(cell)
    assert rc == 0 and res["correct"] is False, res
    checks = res["checks"]
    assert checks["orth"]["value"] > 0.5 > checks["orth"]["limit"]


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of a cell on the card, its result line read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, os.path.join(PB, "run.py"), "--workload",
                          "tlr_thomas_fwd", "--seed", "4000000001", "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert 0 < res["metrics"]["thomas_roofline"]["value"] <= 100
