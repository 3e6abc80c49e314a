"""Parity of the port's structured operators with xitorch_tpu.

Operators are built in both packages from the same numpy arrays (the
port's through ``convert.operator_from_numpy``); matvecs, dense forms and
the kernel layouts must agree to 1e-10 at float64 (summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xitorch_tpu as xj
import xitorch_tpu_torch as xt
from xitorch_tpu_torch.convert import operator_from_numpy

torch.set_num_threads(1)

TOL = 1e-10  # float64; only the order of the sums differs
B, N, R = 3, 12, 2


def _tridiag(case, seed=0):
    rng = np.random.default_rng(seed)
    d = 4.0 + rng.uniform(size=(B, N))
    c = {"array": 0.5 + 0.1 * rng.uniform(size=(B, N - 1)), "scalar": np.asarray(0.7),
         "none": None}[case[0]]
    V = rng.standard_normal((B, N, R)) / np.sqrt(N) if case[1] else None
    Aj = xj.TridiagLowRankOperator(
        jnp.asarray(d), None if c is None else jnp.asarray(c),
        None if V is None else jnp.asarray(V))
    params = {k: np.asarray(getattr(Aj, k)) for k in ("d", "c")}
    if V is not None:
        params["V"] = np.asarray(Aj.V)
    return Aj, operator_from_numpy("TridiagLowRankOperator", params, device="cpu")


def _banded(case, seed=1):
    rng = np.random.default_rng(seed)
    d = 6.0 + rng.uniform(size=(B, N))
    bands = {"two": {1: 0.5 * rng.uniform(size=(B, N - 1)),
                     2: 0.3 * rng.uniform(size=(B, N - 2))},
             "scalar": {3: np.asarray(0.5)}, "none": {}}[case[0]]
    V = rng.standard_normal((B, N, R)) / np.sqrt(N) if case[1] else None
    Aj = xj.BandedLowRankOperator(jnp.asarray(d), {o: jnp.asarray(c) for o, c in bands.items()},
                                  None if V is None else jnp.asarray(V))
    params = {"d": np.asarray(Aj.d), "band_vals": [np.asarray(c) for c in Aj.band_vals]}
    if V is not None:
        params["V"] = np.asarray(Aj.V)
    return Aj, operator_from_numpy("BandedLowRankOperator", params, device="cpu",
                                   offsets=Aj.offsets)


TRIDIAG_CASES = [(c, v) for c in ("array", "scalar", "none") for v in (True, False)]
BANDED_CASES = [(c, v) for c in ("two", "scalar", "none") for v in (True, False)]


def _close(jv, tv):
    np.testing.assert_allclose(np.asarray(tv.detach()), np.asarray(jv), atol=TOL, rtol=0)


@pytest.mark.parametrize("case", TRIDIAG_CASES)
def test_tridiag_mv_fullmatrix_couplings(case):
    Aj, At = _tridiag(case)
    assert tuple(Aj.shape) == tuple(At.shape)
    x = np.random.default_rng(5).standard_normal((2, B, N))
    _close(Aj.mv(jnp.asarray(x)), At.mv(torch.as_tensor(x)))
    _close(Aj._mv(jnp.asarray(x)), At._mv(torch.as_tensor(x)))
    _close(Aj.fullmatrix(), At.fullmatrix())
    for a, b in zip(Aj.full_couplings(), At.full_couplings()):
        _close(a, b)
    xt.checklinop(At)


@pytest.mark.parametrize("case", BANDED_CASES)
def test_banded_mv_fullmatrix_bands(case):
    Aj, At = _banded(case)
    x = np.random.default_rng(6).standard_normal((B, N, 3))
    _close(Aj.mm(jnp.asarray(x)), At.mm(torch.as_tensor(x)))
    _close(Aj.fullmatrix(), At.fullmatrix())
    if Aj.offsets:
        for a, b in zip(Aj.full_bands(), At.full_bands()):
            _close(a, b)
    xt.checklinop(At)


def test_params_are_the_named_tensors():
    _, At = _banded(("two", True))
    names = At._getparamnames()
    assert names == ["d", "band_vals[0]", "band_vals[1]", "V"]
    params = At.getlinopparams()
    assert params[0] is At.d and params[1] is At.band_vals[0] and params[3] is At.V


@pytest.mark.parametrize("cls", ["tridiag", "banded"])
def test_complex_dtype_rejected(cls):
    d = np.ones(6, dtype=np.complex128)
    with pytest.raises(RuntimeError):
        xj.TridiagLowRankOperator(jnp.asarray(d)) if cls == "tridiag" \
            else xj.BandedLowRankOperator(jnp.asarray(d))
    with pytest.raises(RuntimeError, match="real dtype"):
        xt.TridiagLowRankOperator(torch.as_tensor(d)) if cls == "tridiag" \
            else xt.BandedLowRankOperator(torch.as_tensor(d))


@pytest.mark.parametrize("bad", ["c_len", "V_rows", "offset0", "band_len"])
def test_bad_shapes_raise(bad):
    d = torch.ones(3, 8)
    with pytest.raises(RuntimeError):
        {"c_len": lambda: xt.TridiagLowRankOperator(d, torch.ones(3, 5)),
         "V_rows": lambda: xt.TridiagLowRankOperator(d, None, torch.ones(3, 7, 2)),
         "offset0": lambda: xt.BandedLowRankOperator(d[0], {0: torch.ones(8)}),
         "band_len": lambda: xt.BandedLowRankOperator(d[0], {2: torch.ones(3)})}[bad]()


def test_convert_matrix_and_dtype_device():
    a = np.random.default_rng(7).standard_normal((4, 4))
    h = a + a.T
    A = operator_from_numpy("MatrixLinearOperator", {"mat": h}, device="cpu",
                            dtype=torch.float32)
    assert isinstance(A, xt.MatrixLinearOperator) and A.is_hermitian
    assert A.dtype == torch.float32 and A.device.type == "cpu"
    with pytest.raises(ValueError):
        operator_from_numpy("KronOperator", {"mat": h}, device="cpu")
    with pytest.raises(ValueError):
        operator_from_numpy("BandedLowRankOperator",
                            {"d": np.ones(5), "band_vals": [np.ones(4)]}, device="cpu")


def test_convert_defaults_to_the_card_and_raises_without_one(monkeypatch):
    # with no device named the tensors go to the card; with no card the
    # carry-across raises instead of building on the CPU
    from xitorch_tpu_torch.convert import pencil_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = np.eye(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        operator_from_numpy("MatrixLinearOperator", {"mat": h})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        operator_from_numpy("TridiagLowRankOperator", {"d": np.ones((2, 8)), "c": np.ones(7)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pencil_from_numpy(h, h)
    # a device named is taken as it is
    A, M = pencil_from_numpy(h, h, device="cpu")
    assert A.device.type == M.device.type == "cpu"
