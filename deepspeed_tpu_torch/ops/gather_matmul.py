"""Fused ZeRO-3 gather-matmul: the MLP whose matmuls issue the following
matmuls' parameter all-gathers ahead of themselves.

Port of ``deepspeed_tpu/ops/pallas/gather_matmul.py``.  The JAX package
runs the layer MLP inside a ``shard_map`` over the ZeRO axes: every weight
shard is all-gathered explicitly, the second matmul's gather (and the
SwiGLU gate's, and the pre-activation bias') is issued before the first
matmul runs, and each matmul is one blocked Pallas kernel
(``_matmul_kernel``, launched by ``_matmul_impl``) that the compiler cannot
reorder around the gather in flight.  Here the gathers are the
asynchronous all-gathers of ``comm/comm.py`` through the stage-3 gather
``Function`` of ``zero.py`` (issued first, waited on just before their
use), and each matmul is the hand-written Hopper GEMM of
``ops/csrc/gather_matmul.cu``.

* :func:`gemm` — the kernel wrapper: ``[M, K] @ [K, N]`` with fp32
  accumulation and the operands' dtype out, on any strided 2-D views (a
  transposed view is read in place).  CUDA tensors launch the kernel on
  the route :func:`route` picks from the operands (counted in
  ``gemm.launches``, in total, and ``gemm.routes``, by route) or raise;
  CPU tensors take :func:`matmul_ref`, the plain version.
* :func:`matmul` — the differentiable product, ``pallas_matmul`` with its
  ``_mm_fwd``/``_mm_bwd``: dx = g·wᵀ and dw = xᵀ·g through the same
  kernel, dx cast to x's dtype and dw to w's.
* :func:`gather_matmul` and :func:`fused_gather_mlp` — the fused region.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import zero

# the TPU kernel's block depth: the plain version sums K in these chunks
BLK_K = 256
# the kernel's routes by their code in ops/csrc/gather_matmul.cu
ROUTES = ("fma", "mma", "wgmma")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: expected [M, K] @ [K, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"gemm: operands of one dtype, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"gemm: operands on {a.device} and {b.device}")


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the products in fp32, summed over K in
    ``BLK_K`` chunks into an fp32 accumulator (the TPU kernel's scratch),
    rounded once to the operands' dtype."""
    _check(a, b)
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, BLK_K):
        acc += a[:, k0:k0 + BLK_K].float() @ b[k0:k0 + BLK_K].float()
    return acc.to(a.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.load("gather_matmul")
    if not getattr(lib, "_bound", False):
        lib.gather_matmul.argtypes = [_I, _P, _P, _P, _I, _I, _I,
                                      _L, _L, _L, _L, _P]
        lib.gather_matmul.restype = _I
        lib._bound = True
    return lib


def _strides(t: torch.Tensor) -> Tuple[int, int]:
    """Element strides of a 2-D view; a dim of size one gets stride 1 (it
    is never stepped), so a row or column vector reads as contiguous."""
    sr, sc = t.stride()
    return (1 if t.shape[0] == 1 else sr), (1 if t.shape[1] == 1 else sc)


def _tma_readable(t: torch.Tensor) -> bool:
    """A 2-D bf16 view TMA can load: unit stride along one axis, the other
    stride a positive multiple of 8 elements (16 bytes), the base 16-byte
    aligned."""
    sr, sc = _strides(t)
    other = sr if sc == 1 else sc if sr == 1 else 0
    return other > 0 and other % 8 == 0 and t.data_ptr() % 16 == 0


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel route for ``a @ b``, from dtype, strides, shape and
    alignment alone: ``"fma"`` for fp32 (full fp32, the card-vs-CPU
    reference); ``"wgmma"`` for bf16 operands TMA can read (see
    :func:`_tma_readable`) with K > 0; ``"mma"`` for any other bf16
    operands (a stride-0 gradient, a row pitch off 8 elements, a
    misaligned base)."""
    if a.dtype == torch.float32:
        return "fma"
    if a.shape[1] > 0 and _tma_readable(a) and _tma_readable(b):
        return "wgmma"
    return "mma"


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` → ``[M, N]`` contiguous in the operands'
    dtype, fp32 accumulation.  ``a`` and ``b`` may be any strided views
    (``w.T`` is read in place).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    _check(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm: the kernel takes fp32 or bf16, got {a.dtype}")
    if min(a.stride() + b.stride()) < 0:
        raise ValueError("gemm: negative strides")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    path = route(a, b)
    err = _lib().gather_matmul(ROUTES.index(path), a.data_ptr(),
                               b.data_ptr(), out.data_ptr(), m, n, k,
                               *_strides(a), *_strides(b),
                               torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"gather_matmul kernel launch failed ({path} "
                           f"route): CUDA error {err}")
    gemm.launches["gather_matmul"] += 1
    gemm.routes[f"gather_matmul.{path}"] += 1
    return out


gemm.launches = {"gather_matmul": 0}
gemm.routes = {f"gather_matmul.{r}": 0 for r in ROUTES}


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return gemm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gemm(g, w.T).to(x.dtype)     # [M, N] @ [N, K]
        if ctx.needs_input_grad[1]:
            dw = gemm(x.T, g).to(w.dtype)     # [K, M] @ [M, N]
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``x [M, K] @ w [K, N]`` through the kernel, forward
    and backward (``pallas_matmul``)."""
    return _Matmul.apply(x, w)


def gather_matmul(x: torch.Tensor, w_shard: torch.Tensor, group, dim: int,
                  prefetch: Sequence[Tuple[torch.Tensor, int]] = ()):
    """One fused gather-matmul: issue the all-gathers of every ``(shard,
    dim)`` in ``prefetch`` first (the following matmuls' weights), then
    gather ``w_shard`` along ``dim`` and multiply ``x [..., K]`` by it
    through the kernel.  Shards are cast to x's dtype before they travel.
    Returns ``(y, pending)``: ``pending`` holds the prefetches' handles, in
    order, for :func:`zero.gathered` at their use."""
    nexts = tuple(zero.issue_gather(s, d, group, x.dtype) for s, d in prefetch)
    w = zero.gather(w_shard, dim, group, x.dtype)
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(lead + (w.shape[1],)), nexts


def fused_gather_mlp(x: torch.Tensor, p, cfg, topo) -> torch.Tensor:
    """The transformer MLP on the fused gather-matmul path
    (``step_schedule.fused_gather_matmul``; called from
    ``models/transformer.py`` ``_mlp_block`` when the engine enabled the
    flag).  ``x [B, S, H]``: this rank's rows; ``p``: the layer's mlp shards
    over the ZeRO group of ``topo``, wi/wg split on their embed dim 0 and
    wo on its embed dim 1 (and bi on dim 0), as the engine verified.  The
    output bias stays outside (the caller adds it)."""
    group = topo.world_group
    swiglu = cfg.activation == "swiglu"
    bi = p.get("bi")
    has_bi = bi is not None and not swiglu
    # the SECOND matmul's gather (and the gate branch's, and the
    # pre-activation bias') issues before the first matmul runs
    pre = [(p["wo"], 1)]
    if swiglu:
        pre.append((p["wg"], 0))
    if has_bi:
        pre.append((bi, 0))
    h, nexts = gather_matmul(x, p["wi"], group, 0, prefetch=pre)
    wo_pending, rest = nexts[0], list(nexts[1:])
    lead = x.shape[:-1]
    if has_bi:
        h = h + zero.gathered(bi, rest.pop(0), 0, group)
    if swiglu:
        wg = zero.gathered(p["wg"], rest.pop(0), 0, group)
        gate = matmul(x.reshape(-1, x.shape[-1]), wg)
        h = F.silu(gate.reshape(lead + (wg.shape[1],))) * h
    elif cfg.activation == "relu":
        h = F.relu(h)
    else:
        h = F.gelu(h, approximate="none" if cfg.activation == "gelu_exact"
                   else "tanh")
    wo = zero.gathered(p["wo"], wo_pending, 1, group)
    y = matmul(h.reshape(-1, h.shape[-1]), wo)
    return y.reshape(lead + (wo.shape[1],))
