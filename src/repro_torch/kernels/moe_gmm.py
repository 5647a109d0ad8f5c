"""MoE grouped expert matmuls over dense (E, C, D) capacity buffers.

PyTorch counterpart of ``repro.kernels.moe_gmm``:

    up   (B7):  silu(x @ w1) * (x @ w3)   (E, C, D) x (E, D, F) -> (E, C, F)
    down (B8):  h @ w2                    (E, C, F) x (E, F, D) -> (E, C, D)

Both products accumulate in float32; the up kernel takes
``silu(acc1) * acc3`` in float32; each result is cast once to the input
dtype.  Two versions of each, one contract:

- the plain PyTorch version (:func:`_moe_gmm_torch`,
  :func:`_moe_gmm_down_torch`): upcast to float32, ``torch.einsum``, silu
  and multiply, one cast.  CPU tensors take it and ``backend="torch"``
  forces it;
- the CUDA kernels B7/B8, ``csrc/moe_gmm.cu``, which CUDA tensors take:
  bf16 tiles in shared memory, ``mma.sync`` bf16 products with float32
  accumulators, each weight tile read once for all the rows of its block.

They agree to float32 summation order: the kernel adds its products in
another order than the float32 einsum, so an element can land one bf16
ulp apart after the final cast.
"""
from __future__ import annotations

import torch

from . import _build

_SIGNATURES = {"moe_gmm_up_launch": (4, 4), "moe_gmm_down_launch": (3, 4)}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _moe_gmm_torch(x, w1, w3):
    xf = x.float()
    h1 = torch.einsum("ecd,edf->ecf", xf, w1.float())
    h3 = torch.einsum("ecd,edf->ecf", xf, w3.float())
    return (h1 * torch.sigmoid(h1) * h3).to(x.dtype)


def _moe_gmm_down_torch(h, w2):
    return torch.einsum("ecf,efd->ecd", h.float(), w2.float()).to(h.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels B7 and B8
# ---------------------------------------------------------------------------

def _launch(fn_name: str, out, ptrs, dims) -> None:
    lib = _build.library("moe_gmm", _SIGNATURES)
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(getattr(lib, fn_name)(
            *(t.data_ptr() for t in ptrs), out.data_ptr(), *dims, stream),
            fn_name)


def _check(x, ws, names, x_shape, w_shape, device, cuda: bool):
    dtypes = (torch.bfloat16,) if cuda else (x.dtype,)
    if not cuda and not x.dtype.is_floating_point:
        raise TypeError(f"{names[0]} must be a floating tensor, got {x.dtype}")
    _build.expect(x, names[0], x_shape, dtypes, device)
    for name, w in zip(names[1:], ws):
        _build.expect(w, name, w_shape, dtypes, device)


def moe_gmm(x, w1, w3, *, backend: str | None = None):
    """Gated expert up-projection (kernel B7).

    ``x``: (E, C, D); ``w1``, ``w3``: (E, D, F), all one dtype on one device
    and contiguous -> ``silu(x @ w1) * (x @ w3)``: (E, C, F) in that dtype.
    CPU tensors take the plain version, CUDA tensors launch the kernel
    (bf16 only) or raise; ``backend="torch"`` forces the plain version.
    """
    E, C, D = x.shape
    Fh = w1.shape[-1]
    dev = x.device
    cuda = _build.route(backend, dev) == "cuda"
    _check(x, (w1, w3), ("x", "w1", "w3"), (E, C, D), (E, D, Fh), dev, cuda)
    if not cuda:
        return _moe_gmm_torch(x, w1, w3)
    out = torch.empty((E, C, Fh), dtype=x.dtype, device=dev)
    if out.numel():
        _launch("moe_gmm_up_launch", out, (x, w1, w3), (E, C, D, Fh))
        moe_gmm.launches += 1
    return out


def moe_gmm_down(h, w2, *, backend: str | None = None):
    """Expert down-projection (kernel B8).

    ``h``: (E, C, F); ``w2``: (E, F, D) -> ``h @ w2``: (E, C, D), routed as
    :func:`moe_gmm`.
    """
    E, C, Fh = h.shape
    D = w2.shape[-1]
    dev = h.device
    cuda = _build.route(backend, dev) == "cuda"
    _check(h, (w2,), ("h", "w2"), (E, C, Fh), (E, Fh, D), dev, cuda)
    if not cuda:
        return _moe_gmm_down_torch(h, w2)
    out = torch.empty((E, C, D), dtype=h.dtype, device=dev)
    if out.numel():
        _launch("moe_gmm_down_launch", out, (h, w2), (E, C, Fh, D))
        moe_gmm_down.launches += 1
    return out


#: kernel launches by :func:`moe_gmm` and :func:`moe_gmm_down` (one per call
#: that ran a kernel)
moe_gmm.launches = 0
moe_gmm_down.launches = 0
