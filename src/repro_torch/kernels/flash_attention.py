"""Causal GQA flash attention with an online softmax.

PyTorch counterpart of ``repro.kernels.flash_attention`` (with the grouping
that ``repro.kernels.ops.flash_attention`` does around it).  Query head h
reads KV group ``h // G``; the keys are walked in blocks, and per query row
the running max ``m``, the running sum ``l`` and the output accumulator are
carried in float32:

    s     = (q @ k_blk^T in float32) * scale, masked entries set to -1e30
    m_new = max(m, rowmax(s));  p = exp(s - m_new) * mask
    corr  = exp(m - m_new);     l = l * corr + rowsum(p)
    acc   = acc * corr + p.astype(v.dtype) @ v_blk   (float32 accumulation)
    out   = acc / max(l, 1e-30), cast to q's dtype

Two versions, one contract:

- the plain PyTorch version (:func:`_flash_attention_torch`), which repeats
  the Pallas body's arithmetic over key blocks of ``min(128, Sk)``.  A query
  row's arithmetic depends only on the key blocking, so it takes all query
  rows of a block at once.  CPU tensors take it and ``backend="torch"``
  forces it;
- the CUDA kernel B4, ``csrc/flash_attention.cu``, which CUDA tensors take
  (Hopper): one block per (batch, head, 128-row query tile); a producer
  thread TMA-loads the 128-key tiles of its KV group into a ring, two
  consumer warpgroups of 64 rows run both products on ``wgmma``, taking
  turns on the tensor cores, with ``ex2.approx`` exponentials; tiles wholly
  above the diagonal are skipped (on such a tile ``corr`` is 1 and ``p`` is
  0, so skipping it changes no bit).  Its launch geometry is planned here
  (:func:`launch_plan`), where the CPU tests can check it.

The kernel sums its products in the tensor cores' order, so an output can
land one bf16 ulp from the plain version's (or one bf16 rounding of an
attention weight further: see ``chip_smoke.FLASH_P_ULP``).

Neither package has a backward for B4: the reference's ``jax.grad``
through the Pallas call fails, and training runs the plain attention route
(``use_pallas=False``).  Under autograd the wrapper raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _build

BLOCK_K = 128                   # the Pallas kernel's default key block
NEG_INF = -1e30
HEAD_DIMS = (64, 128)           # head dims the CUDA kernel is built for

# the CUDA kernel's launch geometry (csrc/flash_attention.cu)
QUERY_TILE = 128                # query rows a block
CONSUMER_ROWS = 64              # rows of each of its two consumer warpgroups
KEY_TILE = 128                  # keys a ring stage
TMA_BOX = (64, 1, 128, 1)       # elements a TMA load, over (D, heads, S, B)
STAGES = {64: 3, 128: 2}        # ring depth by head dim

_SIGNATURES = {"flash_attention_launch": (4, 9, 1)}


# ---------------------------------------------------------------------------
# the CUDA kernel's launch plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LaunchPlan:
    """Where B4's blocks go: ``grid`` is (B * H, query tiles); block (x, y)
    owns batch x // H, head x % H and the query tile counted ``y`` from the
    last (the heaviest tiles are the first row of blocks).  ``stages`` is
    the K/V ring's depth; ``box`` the TMA box over (D, heads, S, B), which
    a head dim of 128 takes twice; ``smem_bytes`` the dynamic shared memory
    a block asks for (Q, the ring, its barriers, 1024 bytes of alignment)."""

    grid: tuple[int, int]
    stages: int
    box: tuple[int, int, int, int]
    smem_bytes: int


def launch_plan(B: int, Sq: int, H: int, D: int) -> LaunchPlan:
    """B4's grid, ring depth and TMA box (see :class:`LaunchPlan`)."""
    stages = STAGES[D]
    smem = (1024 + QUERY_TILE * D * 2 + stages * 2 * KEY_TILE * D * 2
            + (1 + 2 * stages) * 8)
    return LaunchPlan(grid=(B * H, math.ceil(Sq / QUERY_TILE)),
                      stages=stages, box=TMA_BOX, smem_bytes=smem)


def block_work(plan: LaunchPlan, Sq: int, Sk: int, H: int, KV: int,
               causal: bool, x: int, y: int):
    """What block (x, y) computes, indexed as the kernel does: ``(batch,
    head, KV group, row ranges, key range)``, one row range (clipped to Sq)
    per consumer warpgroup, and the keys of the tiles it loads (clipped to
    Sk; with ``causal`` none past its last row)."""
    b, h = divmod(x, H)
    q0 = (plan.grid[1] - 1 - y) * QUERY_TILE
    n_kv = math.ceil(Sk / KEY_TILE)
    if causal:
        n_kv = min(n_kv, (min(q0 + QUERY_TILE, Sq) - 1) // KEY_TILE + 1)
    rows = [range(min(q0 + c * CONSUMER_ROWS, Sq),
                  min(q0 + (c + 1) * CONSUMER_ROWS, Sq)) for c in range(2)]
    return b, h, h // (H // KV), rows, range(0, min(n_kv * KEY_TILE, Sk))


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _flash_attention_torch(q, k, v, *, scale: float, causal: bool = True,
                           block_k: int = BLOCK_K):
    """The Pallas body over key blocks of ``min(block_k, Sk)``, all query
    rows at once.  q: (B, Sq, H, D); k, v: (B, Sk, KV, D)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    bk = min(block_k, Sk)
    qf = q.reshape(B, Sq, KV, G, D).float()
    scale_t = torch.full((), scale, dtype=torch.float32, device=dev)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, Sq, KV, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, bk):
        kb = k[:, k0:k0 + bk].float()
        vb = v[:, k0:k0 + bk]
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kb) * scale_t
        mask = (k0 + torch.arange(kb.shape[1], device=dev))[None, :] < Sk
        if causal:
            mask = mask & (q_pos >= k0 + torch.arange(kb.shape[1], device=dev))
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# CUDA kernel B4
# ---------------------------------------------------------------------------

def _flash_attention_cuda(q, k, v, scale: float, causal: bool):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _build.tma_ready(t):
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if Sk == 0:                       # no keys: acc = 0, so out = 0
        return out.zero_()
    plan = launch_plan(B, Sq, H, D)
    lib = _build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.flash_attention_launch(
            *(t.data_ptr() for t in (q, k, v, out)),
            B, Sq, Sk, H, KV, D, int(causal), *plan.grid, scale, stream),
            "flash_attention_launch")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    backend: str | None = None):
    """Causal GQA attention with an online softmax (kernel B4).

    ``q``: (B, Sq, H, D); ``k``, ``v``: (B, Sk, KV, D) with H = KV * G, all
    contiguous on one device.  Returns (B, Sq, H, D) in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16,
    D in {64, 128}) or raise; ``backend="torch"`` forces the plain version.
    Raises ``NotImplementedError`` under autograd: B4 has no backward.
    """
    _build.forbid_autograd("flash attention (B4)", q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    dev = q.device
    cuda = _build.route(backend, dev) == "cuda"
    if cuda and D not in HEAD_DIMS:
        raise ValueError(f"the B4 kernel takes head dims {HEAD_DIMS}, got {D}")
    dtypes = (torch.bfloat16,) if cuda else (q.dtype,)
    _build.expect(q, "q", (B, Sq, H, D), dtypes, dev)
    _build.expect(k, "k", (B, Sk, KV, D), dtypes, dev)
    _build.expect(v, "v", (B, Sk, KV, D), dtypes, dev)
    if not cuda:
        return _flash_attention_torch(q, k, v, scale=scale, causal=causal)
    return _flash_attention_cuda(q, k, v, scale, causal)


#: kernel launches by :func:`flash_attention` (one per call that ran the kernel)
flash_attention.launches = 0
