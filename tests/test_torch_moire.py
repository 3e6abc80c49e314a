"""The Bistritzer-MacDonald continuum model (``xitorch_tpu_torch/models/moire.py``)
and its benchmark cell ``tbg_flatband_grad``, on the CPU.

The port's Hamiltonian is held to the plain reference's own build
(``portbench/reference/moire_bm.py``, loops over G, float64); its bands,
flat-band energy and gradient through ``linalg.symeig`` to the
reference's float64 ``eigh`` and autograd; the equations themselves to
the physics they must show (an isolated flat pair at the magic angle, a
dispersive one at 2 degrees); and the cell, run through the harness at a
tiny mesh, to its limits: the program correct, the TF32 control and
three faults under the timed path not."""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.reference import moire_bm
from xitorch_tpu_torch.models import moire

torch.set_num_threads(1)

HV, A_NM = 2.1354 * 0.246, 0.246
MAGIC = (1.05, 0.0797, 0.0975)
CELL = "tbg_flatband_grad"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f64(*vals):
    return [torch.tensor(v, dtype=torch.float64) for v in vals]


def _kpts(K, seed=0, dtype=torch.float64):
    return torch.rand(K, 2, generator=torch.Generator().manual_seed(seed), dtype=dtype)


def _mesh(side):
    f = (torch.arange(side, dtype=torch.float64) + 0.5) / side
    return torch.stack(torch.meshgrid(f, f, indexing="ij"), -1).reshape(-1, 2)


@pytest.mark.parametrize("cutoff,n", [(1, 28), (2, 76)])
def test_hamiltonian_matches_the_reference_build(cutoff, n):
    k = _kpts(6)
    args = (*_f64(1.1, 0.08, 0.1), HV, A_NM, cutoff)
    H = moire.bm_hamiltonian(k, *args)
    ref = moire_bm.hamiltonian(k, *args)
    assert H.shape == (6, n, n) and n == 4 * (3 * cutoff * (cutoff + 1) + 1)
    assert H.dtype == torch.complex128
    assert (H - ref).abs().max() <= 1e-12
    assert torch.equal(H, H.mH)
    H32 = moire.bm_hamiltonian(k.float(), *args)
    assert H32.dtype == torch.complex64 and torch.equal(H32, H32.mH)
    assert (H32.to(torch.complex128) - ref).abs().max() <= 1e-6 * ref.abs().max()


def _port(kpts, params, cutoff):
    """L, evals and dL/d(theta, u, u') through the port's public path."""
    leaves = [torch.tensor(v, dtype=kpts.dtype, requires_grad=True) for v in params]
    L, evals, evecs = moire.flat_band_loss(kpts, *leaves, HV, A_NM, cutoff)
    return L, evals, evecs, torch.stack(torch.autograd.grad(L, leaves))


def test_bands_loss_and_gradient_match_the_reference_in_float64():
    k = _kpts(8, seed=1)
    params = (1.08, 0.081, 0.096)
    L, evals, evecs, grad = _port(k, params, 2)
    inputs = {"kpts": k, **dict(zip(("theta", "u", "u_prime"), _f64(*params)))}
    cfg = {"hbar_v_over_a_eV": 2.1354, "a_nm": A_NM, "cutoff": 2}
    _, lam, Lref, gref, scale = moire_bm.truth(cfg, inputs)
    torch.testing.assert_close(evals, lam, rtol=1e-8, atol=1e-12)
    torch.testing.assert_close(L, Lref, rtol=1e-8, atol=0)
    torch.testing.assert_close(grad, gref, rtol=1e-8, atol=0)
    assert (gref.abs() > 1e-7).all()


def test_reference_derivatives_and_gradient_scale():
    """The reference's dH/dp are the derivatives of its own build (central
    differences), its Hellmann-Feynman terms average to its autograd
    gradient, and each gradient's scale bounds the gradient (|dL/dp| <=
    scale / |H|_2 * max |E_flat|)."""
    k = _kpts(4, seed=5)
    theta, u, up = _f64(1.06, 0.08, 0.097)
    dH = moire_bm.derivatives(k, theta, HV, A_NM, 2)
    for i, D in enumerate(dH):
        h = 1e-5
        args = [[theta, u, up], [theta, u, up]]
        args[0][i], args[1][i] = args[0][i] + h, args[1][i] - h
        fd = (moire_bm.hamiltonian(k, *args[0], HV, A_NM, 2)
              - moire_bm.hamiltonian(k, *args[1], HV, A_NM, 2)) / (2 * h)
        assert (fd - D).abs().max() <= 1e-7 * D.abs().max()
    inputs = {"kpts": k, "theta": theta, "u": u, "u_prime": up}
    cfg = {"hbar_v_over_a_eV": 2.1354, "a_nm": A_NM, "cutoff": 2}
    _, lam, _, gref, scale = moire_bm.truth(cfg, inputs)
    lam_, X = torch.linalg.eigh(moire_bm.hamiltonian(k, theta, u, up, HV, A_NM, 2))
    E, V = lam_[:, 37:39], X[..., 37:39]
    hf = torch.stack([(2 * E * (V.conj() * (D @ V)).sum(-2).real).sum(-1).mean() for D in dH])
    torch.testing.assert_close(hf, gref, rtol=1e-9, atol=0)
    top = (lam.abs().amax(-1) / lam[:, 37:39].abs().amax(-1)).min()
    assert (gref.abs() * top <= scale).all() and (scale > 0).all()


def test_float32_port_meets_the_cells_limits():
    """At the cell's cutoff in float32 every compared number (eigenvalues
    over all bands and on the flat pair, residuals, orthonormality, the
    three derivatives) lies under the cell's limit, as on the card."""
    cell = harness.Cell(CELL)
    k = _kpts(3, seed=2, dtype=torch.float32)
    params = (1.04, 0.079, 0.098)
    L, evals, evecs, grad = _port(k, params, cell.config["cutoff"])
    assert evals.shape == (3, 244) and evecs.dtype == torch.complex64
    inputs = {"kpts": k, **{key: torch.tensor(v) for key, v in
                            zip(("theta", "u", "u_prime"), params)}}
    got = moire_bm.judge(cell.config, cell.traffic, inputs,
                         {"evals": evals, "evecs": evecs, "L": L, "grad": grad})
    assert set(got) == set(cell.limits)
    for key, v in got.items():
        assert v <= cell.limits[key]["limit"], (key, v)


def _spectrum_report(theta):
    """(width, gap above, gap below) of the two central bands, in meV, on an
    8 x 8 mesh of the reference in float64 at the cell's cutoff."""
    H = moire_bm.hamiltonian(_mesh(8), *_f64(theta, *MAGIC[1:]), HV, A_NM, 4)
    e = torch.linalg.eigvalsh(H) * 1e3
    c = e.shape[-1] // 2
    width = float(e[:, c].max() - e[:, c - 1].min())
    return width, float(e[:, c + 1].min() - e[:, c].max()), float(e[:, c - 1].min()
                                                                 - e[:, c - 2].max())


def test_magic_angle_gives_an_isolated_flat_pair_and_two_degrees_a_dispersive_one():
    width, up, down = _spectrum_report(1.05)
    assert width < 10 and up > 10 and down > 10, (width, up, down)
    width2, _, _ = _spectrum_report(2.0)
    assert width2 > 50, width2


def test_gradcheck_of_the_flat_band_energy():
    k = _kpts(3, seed=4)

    def loss(theta, u, up):
        return moire.flat_band_loss(k, theta, u, up, HV, A_NM, 1)[0]

    params = [t.requires_grad_(True) for t in _f64(1.2, 0.085, 0.1)]
    assert torch.autograd.gradcheck(loss, params, eps=1e-7, atol=1e-9, rtol=1e-5)


def _tiny_cell():
    cell = harness.Cell(CELL)
    cell.traffic = dict(cell.traffic, systems=4)
    return cell


# The harness refuses a process that has loaded JAX, as this suite's
# conftest does, so the cell's runs are made in one fresh process: the
# program as it is, traced and not, then with symeig broken where the
# model calls it (half of the k-points' answers left out, one eigenvalue
# altered, an eigenvector returned twice).
_RUNS = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from portbench import harness
from xitorch_tpu_torch.models import moire


def half_left_out(evals, evecs):
    keep = torch.ones(evals.shape[0], 1)
    keep[evals.shape[0] // 2:] = 0
    return evals * keep, evecs * keep[..., None]


def one_altered(evals, evecs):
    bump = torch.zeros_like(evals)
    bump.view(-1)[evals.numel() // 3] = 1e-2 * float(evals.detach().abs().max())
    return evals + bump, evecs


def duplicated(evals, evecs):
    evecs = evecs.clone()
    evecs[..., 1] = evecs[..., 0]
    return evals, evecs


real = moire.symeig
out = {}
for name, trace, fault in [("plain", False, None), ("traced", True, None),
                           ("half_left_out", False, half_left_out),
                           ("one_altered", False, one_altered),
                           ("duplicated", False, duplicated)]:
    moire.symeig = real if fault is None else (lambda *a, f=fault, **k: f(*real(*a, **k)))
    cell = harness.Cell(%r)
    cell.traffic = dict(cell.traffic, systems=4)
    out[name] = harness.run(cell, 2 ** 31 + 11, 0.2, trace, time.perf_counter(), device="cpu")
print(json.dumps(out))
""" % CELL


@pytest.fixture(scope="module")
def cpu_runs():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _RUNS], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("run", ["plain", "traced"])
def test_cell_runs_correct_on_the_cpu(cpu_runs, run):
    rc, res = cpu_runs[run]
    assert rc == 0 and res["correct"] is True, res
    assert set(res["checks"]) == {"eval_err", "flat_err", "resid", "orth", "grad_err"}
    key = "host_issue_ms" if run == "traced" else "systems_per_s"
    assert res["metrics"][key]["value"] > 0


@pytest.mark.parametrize("fault", ["half_left_out", "one_altered", "duplicated"])
def test_a_fault_under_the_timed_path_comes_out_not_correct(cpu_runs, fault):
    rc, res = cpu_runs[fault]
    assert rc == 0 and res["correct"] is False, res
    if fault == "duplicated":
        assert res["checks"]["orth"]["value"] > 0.5


def test_entry_draws_from_the_seed_inside_the_published_spread():
    cell = _tiny_cell()
    mod = cell.entry_module()
    one = mod.make(cell.config, cell.traffic, 2 ** 31 + 5, torch.device("cpu"))
    two = mod.make(cell.config, cell.traffic, 2 ** 31 + 5, torch.device("cpu"))
    other = mod.make(cell.config, cell.traffic, 6, torch.device("cpu"))
    assert len(one.sets) == 2 and one.systems == 4 and one.kernels == ["jacobi_sweep_complex"]
    for s, t, o in zip(one.sets, two.sets, other.sets):
        assert all(torch.equal(s[k], t[k]) for k in s)
        assert not torch.equal(s["kpts"], o["kpts"])
        for key, name in mod.PARAMS:
            assert abs(float(s[key].detach()) / cell.config[name] - 1) <= 0.02 + 1e-6
            assert s[key].requires_grad and s[key].dtype == torch.float32
        # the 2 x 2 mesh shifted by one offset inside one mesh cell
        step = s["kpts"].double() - s["kpts"][0].double()
        assert torch.allclose(step, torch.tensor([[0, 0], [0, .5], [.5, 0], [.5, .5]],
                                                 dtype=torch.float64), atol=1e-7)
        assert (0 <= s["kpts"][0]).all() and (s["kpts"][0] < 0.5).all()
    with pytest.raises(SystemExit):
        mod.make(cell.config, dict(cell.traffic, systems=3), 1, torch.device("cpu"))


def test_control_comes_out_not_correct():
    cell = _tiny_cell()
    entry = cell.entry_module().make(cell.config, cell.traffic, 3, torch.device("cpu"))
    ref = cell.reference()
    keep = {s: ref.control(cell.config, cell.traffic, entry.sets[s])
            for s in range(len(entry.sets))}
    correct, checks = harness.judge(cell, entry, keep)
    assert not correct, checks


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse(open(moire_bm.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"contextlib", "math", "torch", "portbench"}
