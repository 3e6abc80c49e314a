"""Plain reference of config 2: the ``neig`` lowest (or uppermost)
eigenpairs of dense symmetric matrices.

The truth is ``torch.linalg.eigvalsh`` in float64.  An eigenvalue is
judged against it, relative to the matrix's spectral norm; an eigenvector
by its float64 residual ``|A x - lam x| / (|A| |x|)`` with the port's own
lam (the lowest eigenvalues of these matrices lie ~1e-4 apart, so a
single vector is not a well-posed thing to compare, while its residual
is).  Neighbouring eigenvalues lie closer than the residual's limit, so a
vector returned twice, or two neighbours mixed, keeps a small residual:
the block's orthonormality ``|X^T X - I|`` catches them.  The control:
``torch.linalg.eigh`` in float32 of the matrices rounded to TF32.
"""
import torch

from portbench.reference.precision import round_tf32, tf32_products


def _take(evals, cfg):
    k = cfg["neig"]
    return evals[..., :k] if cfg["mode"] == "lowest" else evals[..., -k:]


def judge(cfg, traffic, inputs, outputs):
    """``eval_err``: the widest ``|lam - lam_ref| / |A|``; ``resid``: the
    widest eigenvector residual; ``orth``: the widest entry of
    ``|X^T X - I|``; over every matrix and pair of the call."""
    A = inputs["A"].to(torch.float64)
    ref = torch.linalg.eigvalsh(A)
    norm = ref.abs().amax(-1)
    lam = outputs["evals"].to(torch.float64)
    X = outputs["evecs"].to(torch.float64)
    eval_err = ((lam - _take(ref, cfg)).abs() / norm[:, None]).amax()
    R = A @ X - X * lam[:, None, :]
    resid = (torch.linalg.vector_norm(R, dim=-2)
             / (norm[:, None] * torch.linalg.vector_norm(X, dim=-2))).amax()
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    orth = (X.mT @ X - eye).abs().amax()
    return {"eval_err": float(eval_err), "resid": float(resid), "orth": float(orth)}


def control(cfg, traffic, inputs):
    """The reference in the program's place at TF32: the matrices rounded
    to TF32, ``eigh`` in float32."""
    with tf32_products():
        evals, evecs = torch.linalg.eigh(round_tf32(inputs["A"]))
    k = cfg["neig"]
    if cfg["mode"] == "lowest":
        return {"evals": evals[..., :k], "evecs": evecs[..., :k]}
    return {"evals": evals[..., -k:], "evecs": evecs[..., -k:]}
