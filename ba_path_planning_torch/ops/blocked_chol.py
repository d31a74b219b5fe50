"""Matmul-form Cholesky factorization with a fused triangular inverse
(counterpart of ``ba_path_planning_tpu.ops.blocked_chol``).

Both are recursive 2x2 block algorithms whose work is almost all batched
matmuls, plus an unrolled rank-1 Cholesky on diagonal blocks of at most
``_BASE`` rows:

    chol_inv(S) -> (L, L^{-1})        with S = L L^T

        [S11 S21^T]      L = [L11   0 ]     Linv = [ X11        0  ]
        [S21 S22  ]          [L21  L22]            [-X22 L21 X11  X22]

so a block-tridiagonal factorization needs no triangular solve
(``banded.factorize_matmul``).  The JAX package routes it at n >= 32 off
the CPU for the TPU's matrix unit; the port's factorizations stay on
cuSOLVER (``banded.factorize``), and this form is kept as the JAX
package's alternative, timed against cuSOLVER on the card.

Every product is exact FP32 (JAX's ``Precision.HIGHEST``): the normal
matrices carry the equality-row rho boost (~1e3 conditioning), which TF32
passes would not survive, so the functions run with the float32 matmul
precision at "highest" whatever the caller set.
"""

from __future__ import annotations

import contextlib

import torch

# Diagonal blocks at or below this size use the unrolled rank-1 algorithm.
_BASE = 16


@contextlib.contextmanager
def exact_fp32():
    """FP32 products without TF32 for the block, the caller's setting
    restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _chol_unrolled(S: torch.Tensor) -> torch.Tensor:
    """Right-looking rank-1 Cholesky for small blocks, unrolled.

    S: (..., b, b) SPD with b <= _BASE.  Every step is elementwise work on
    the whole batch."""
    b = S.shape[-1]
    rows = torch.arange(b, device=S.device)
    cols = []
    for j in range(b):
        d = torch.sqrt(S[..., j, j])
        col = S[..., :, j] / d[..., None]
        col = col * (rows >= j).to(S.dtype)
        cols.append(col)
        S = S - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    n = L.shape[-1]
    if n == 1:
        return 1.0 / L
    m = n // 2
    X11 = _tri_inv(L[..., :m, :m])
    X22 = _tri_inv(L[..., m:, m:])
    X21 = -(X22 @ (L[..., m:, :m] @ X11))
    return _blocks(X11, X21, X22)


def _blocks(A11, A21, A22):
    """The lower block-triangular [[A11, 0], [A21, A22]]."""
    zt = A11.new_zeros(A11.shape[:-1] + (A22.shape[-1],))
    return torch.cat([torch.cat([A11, zt], dim=-1),
                      torch.cat([A21, A22], dim=-1)], dim=-2)


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of lower-triangular L (..., n, n) by the recursive block
    formula inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A),
    inv(C)]]: matmuls of shrinking blocks (~n^3/3 flops)."""
    with exact_fp32():
        return _tri_inv(L)


def _chol_inv(S: torch.Tensor):
    n = S.shape[-1]
    if n <= _BASE:
        L = _chol_unrolled(S)
        return L, _tri_inv(L)
    m = n // 2
    L11, X11 = _chol_inv(S[..., :m, :m])
    L21 = S[..., m:, :m] @ X11.mT
    S22 = S[..., m:, m:] - L21 @ L21.mT
    L22, X22 = _chol_inv(S22)
    X21 = -(X22 @ (L21 @ X11))
    return _blocks(L11, L21, L22), _blocks(X11, X21, X22)


def chol_inv(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cholesky factor and its inverse, fused: S = L L^T, returns
    (L, L^{-1}).  Recursive 2x2 blocking; leaves use the unrolled rank-1
    factorization and the recursive triangular inverse.  S: (..., n, n)
    SPD."""
    with exact_fp32():
        return _chol_inv(S)


def chol_inverse_factor(S: torch.Tensor) -> torch.Tensor:
    """Just L^{-1} from SPD S (the factor the substitution sweeps
    consume)."""
    return chol_inv(S)[1]
