"""Plain reference of config 3: ``A = diag(d) + T(c) + V V^T``, hermitian,
and ``x = A^{-1} b`` (with V None, ``A`` tridiagonal).

A direct solve, independent of the port's CG: the Thomas recurrence for
the tridiagonal part (diagonally dominant: d >= 4 > 2 |c|, no pivoting
needed) applied to b, the r columns of V and the loss weight w together,
then the Woodbury identity for the rank-r term.  The gradients of
``L = sum(x w)`` follow from ``lam = A^{-1} w`` (A symmetric):
``dL/db = lam``, ``dL/dd = -lam * x``,
``dL/dV = -(lam (V^T x)^T + x (V^T lam)^T)``.

The truth is float64; the control (:func:`control`) the same arithmetic
in float32 on inputs rounded to TF32.  Both run in blocks of ``BLOCK``
systems, laid out (n, systems, columns) so that each step of the
recurrence reads one contiguous slab.
"""
import torch

from portbench.reference.precision import round_tf32, tf32_products

BLOCK = 65536


def _thomas(d, c, rhs):
    """Solve ``tridiag(c, d, c) y = rhs`` for d (n, k) and rhs (n, k, m)."""
    n = d.shape[0]
    cp = torch.empty_like(d)
    y = torch.empty_like(rhs)
    den = d[0]
    cp[0] = c / den
    y[0] = rhs[0] / den[:, None]
    for i in range(1, n):
        den = d[i] - c * cp[i - 1]
        cp[i] = c / den
        y[i] = (rhs[i] - c * y[i - 1]) / den[:, None]
    for i in range(n - 2, -1, -1):
        y[i] -= cp[i][:, None] * y[i + 1]
    return y


def _solve_block(cfg, d, V, b, w, dtype):
    """x (and with w, the three gradients) for one block of systems: d (k, n),
    V (k, n, r) or None, b and w (k, n, 1), computed in ``dtype``."""
    c = float(cfg["coupling"])
    cols = [b] + ([V] if V is not None else []) + ([w] if w is not None else [])
    rhs = torch.cat([t.to(dtype) for t in cols], dim=-1).permute(1, 0, 2).contiguous()
    Y = _thomas(d.to(dtype).T.contiguous(), c, rhs).permute(1, 0, 2)
    y, lam = Y[..., :1], (Y[..., -1:] if w is not None else None)
    if V is not None:
        Vd = V.to(dtype)
        r = Vd.shape[-1]
        Z = Y[..., 1:1 + r]
        S = torch.eye(r, dtype=dtype, device=d.device) + Vd.mT @ Z

        def woodbury(t):
            return t - Z @ torch.linalg.solve(S, Vd.mT @ t)

        y = woodbury(y)
        lam = woodbury(lam) if lam is not None else None
    out = {"x": y}
    if w is not None:
        out["gb"] = lam
        out["gd"] = -(lam * y)[..., 0]
        if V is not None:
            out["gV"] = -(lam @ (Vd.mT @ y).mT + y @ (Vd.mT @ lam).mT)
    return out


def _blocks(inputs, block):
    K = inputs["d"].shape[0]
    for k0 in range(0, K, block):
        sl = slice(k0, min(K, k0 + block))
        yield sl, {key: t.detach()[sl] for key, t in inputs.items()}


def _rel(a, t):
    """Each system's relative distance ``|a - t| / |t|`` (float64)."""
    dims = tuple(range(1, t.dim()))
    a = a.to(torch.float64)
    return torch.linalg.vector_norm(a - t, dim=dims) / torch.linalg.vector_norm(t, dim=dims)


def judge(cfg, traffic, inputs, outputs, block=BLOCK):
    """The widest relative distance, over every system of the call, of each
    output from the float64 truth: ``x_err`` and, for a gradient call,
    ``gd_err``, ``gV_err``, ``gb_err``."""
    worst = {}
    for sl, inp in _blocks(inputs, block):
        truth = _solve_block(cfg, inp["d"], inp.get("V"), inp["b"], inp.get("w"),
                             torch.float64)
        for key, t in truth.items():
            e = float(_rel(outputs[key].detach()[sl], t).max())
            e = e if e == e else float("inf")  # a NaN is as far as it gets
            worst[key + "_err"] = max(e, worst.get(key + "_err", 0.0))
    return worst


def control(cfg, traffic, inputs, block=BLOCK):
    """The reference in the program's place at TF32: inputs rounded to TF32,
    float32 arithmetic, products with TF32 allowed."""
    parts = {}
    with tf32_products():
        for _, inp in _blocks(inputs, block):
            r = {k: round_tf32(v) for k, v in inp.items()}
            out = _solve_block(cfg, r["d"], r.get("V"), r["b"], r.get("w"), torch.float32)
            for key, t in out.items():
                parts.setdefault(key, []).append(t)
    return {key: torch.cat(ts) for key, ts in parts.items()}
