"""Chunked WKV6 scan: RWKV6's linear attention with data-dependent decay.

PyTorch counterpart of ``repro.kernels.rwkv6_scan``.  Per head, per step t:

    out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T

evaluated in chunks of ``CHUNK`` = 32 steps: inside a chunk in its
quadratic form (``cw = cumsum(log_w)``, pairwise decays
``exp(clip(cw_i - w_i - cw_j, -60, 0))`` under a strictly lower triangular
mask, and the ``u`` bonus of the current token), and across chunks through
the (Dk, Dv) float32 state ``S' = exp(cw_c)^T * S + (k * exp(cw_c - cw))^T
v``.  Two versions, one contract:

- the plain PyTorch version (:func:`wkv_chunked`, also the model's plain
  route), the Pallas body's math over all (batch, head) pairs at once.
  CPU tensors take it at the Pallas chunk ``min(CHUNK, S)`` and
  ``backend="torch"`` forces it;
- the CUDA kernel B5, ``csrc/rwkv6_scan.cu``, which CUDA tensors take: one
  block per (batch, head), the next chunk prefetched under this one, the
  cumsum a warp scan, the chunk split into two sub-chunks of 16 rows so
  that the decay between them factors with exponents <= 0 (no overflow at
  any decay), and the contractions as 3xTF32 tensor-core products; the
  state stays in registers.

They agree to float32 rounding, not bit for bit: the in-chunk cumsum and
the contractions sum in another order, the products split each float32
into two TF32 parts (about float32 accuracy), and the kernel's exponential
is ``ex2.approx``.  ``tests/test_torch_rwkv6.py`` and
``chip_smoke.py`` state the tolerance (relative to ``max|plain|``).
"""
from __future__ import annotations

import torch

from . import _build

CHUNK = 32                      # the Pallas kernel's chunk (``ops.rwkv6_scan``)
CUDA_HEAD_DIMS = (16, 32, 64)   # head sizes the CUDA kernel is built for

_SIGNATURES = {"rwkv6_scan_launch": (8, 4)}


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one B5 block at head size ``D`` (the
    kernel's ``Layout<D>``): the cumsum (C x (D + 4) float32), three C x D
    float32 arrays and the D x D state at a row pitch of max(D, 32), att
    and the off-diagonal block's second half (C x C each), the bonus
    partials, exp(cw_C) and u, and two raw chunks (bf16 r, k, v and
    float32 log_w)."""
    pitch = max(D, 32)
    floats = (CHUNK * (D + 4) + 3 * CHUNK * pitch + D * pitch
              + 2 * CHUNK * CHUNK + D // 8 * CHUNK + 2 * D)
    return 4 * floats + 2 * (3 * CHUNK * D * 2 + CHUNK * D * 4)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def wkv_chunked(r, k, v, log_w, u, s0, chunk: int = CHUNK):
    """Chunked-parallel WKV6 scan: the plain version of kernel B5 at
    ``min(CHUNK, S)`` and the model's plain route at ``cfg.wkv_chunk``.

    r/k/v: (B, S, H, Dh); log_w: (B, S, H, Dh) fp32; u: (H, Dh);
    s0: (B, H, Dk, Dv) fp32.  Returns (out (B,S,H,Dh) fp32, s_final).
    """
    B, S, H, Dh = r.shape
    n = -(-S // chunk)
    pad = n * chunk - S

    def split(a):                                  # -> (n, B, c, H, Dh)
        a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(B, n, chunk, H, Dh).transpose(0, 1)

    rc, kc, vc, wc = split(r), split(k), split(v), split(log_w)
    s = s0
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    outs = []
    for i in range(n):
        rb32, kb32, vb32 = rc[i].float(), kc[i].float(), vc[i].float()
        wb = wc[i]                                              # (B, c, H, Dh)
        cw = torch.cumsum(wb, dim=1)                            # <= 0
        # inter-chunk: out_i += (r_i * exp(cw_{i-1})) @ s
        r_decayed = rb32 * torch.exp(cw - wb)
        inter = torch.einsum("bchk,bhkv->bchv", r_decayed, s)
        # intra-chunk: pairwise decay ratios exp(cw_{i-1} - cw_j), j < i
        expo = (cw - wb)[:, :, None] - cw[:, None, :, :]        # (B, ci, cj, H, Dh)
        expo = torch.exp(torch.clamp(expo, -60.0, 0.0))
        att = torch.einsum("bihk,bijhk,bjhk->bijh", rb32, expo, kb32)
        att = att * tri[None, :, :, None]
        intra = torch.einsum("bijh,bjhv->bihv", att, vb32)
        # bonus (current token): r_i . (u * k_i) * v_i
        bonus = (rb32 * u * kb32).sum(-1, keepdim=True) * vb32
        outs.append(inter + intra + bonus)
        # state update: s = diag(exp(cw_c)) s + sum_j exp(cw_c - cw_j) k_j v_j
        total = cw[:, -1]                                       # (B, H, Dh)
        k_scaled = kb32 * torch.exp(total[:, None] - cw)
        s = torch.exp(total)[..., None] * s + torch.einsum(
            "bjhk,bjhv->bhkv", k_scaled, vb32)
    out = torch.stack(outs, dim=1).reshape(B, n * chunk, H, Dh)[:, :S]
    return out, s


# ---------------------------------------------------------------------------
# CUDA kernel B5
# ---------------------------------------------------------------------------

def _rwkv6_scan_cuda(r, k, v, log_w, u, s0):
    B, S, H, D = r.shape
    dev = r.device
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=dev)
    s_final = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    if B * H == 0:
        return out, s_final
    # the kernel copies rows in 16-byte pieces from 16-byte boundaries
    r, k, v, log_w = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (r, k, v, log_w))
    lib = _build.library("rwkv6_scan", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.rwkv6_scan_launch(
            *(t.data_ptr() for t in (r, k, v, log_w, u, s0, out, s_final)),
            B, S, H, D, stream), "rwkv6_scan_launch")
    rwkv6_scan.launches += 1
    return out, s_final


def rwkv6_scan(r, k, v, log_w, u, s0, *, backend: str | None = None):
    """Chunked WKV6 scan (kernel B5).

    ``r``, ``k``, ``v``: (B, S, H, D); ``log_w``: (B, S, H, D) float32 log
    decays (<= 0); ``u``: (H, D) float32; ``s0``: (B, H, D, D) float32, all
    contiguous on one device.  Returns ``(out, s_final)``: (B, S, H, D) and
    (B, H, D, D), both float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (r,
    k, v in bf16, D in ``CUDA_HEAD_DIMS``) or raise; ``backend="torch"``
    forces the plain version.  Both run chunks of ``CHUNK`` steps.
    Raises ``NotImplementedError`` under autograd: B5 has no backward.
    """
    _build.forbid_autograd("rwkv6_scan (B5)", r, k, v, log_w, u, s0)
    B, S, H, D = r.shape
    dev = r.device
    cuda = _build.route(backend, dev) == "cuda"
    if cuda:
        act = (torch.bfloat16,)
        if D not in CUDA_HEAD_DIMS:
            raise ValueError(f"the CUDA kernel takes head sizes "
                             f"{CUDA_HEAD_DIMS}, got {D}")
    else:
        if not r.dtype.is_floating_point:
            raise TypeError(f"r must be a floating tensor, got {r.dtype}")
        act = (r.dtype,)
    for name, t in (("r", r), ("k", k), ("v", v)):
        _build.expect(t, name, (B, S, H, D), act, dev)
    _build.expect(log_w, "log_w", (B, S, H, D), (torch.float32,), dev)
    _build.expect(u, "u", (H, D), (torch.float32,), dev)
    _build.expect(s0, "s0", (B, H, D, D), (torch.float32,), dev)
    if not cuda:
        return wkv_chunked(r, k, v, log_w, u, s0, min(CHUNK, S))
    return _rwkv6_scan_cuda(r, k, v, log_w, u, s0)


#: kernel launches by :func:`rwkv6_scan` (one per call that ran the kernel)
rwkv6_scan.launches = 0
