"""Transformer building blocks, the PyTorch twin of the JAX package's
``models/layers.py``: attention with cross-attention inputs and decode
caches (packed [B, T, d] or head-major [B, H, T, dh]), MLP, pre-LN blocks.

Parameters are f32 and named as in the flax tree (``kernel`` [in, out],
``bias``, LayerNorm ``scale``, WF inserts under ``adapter_wf``), so
``models/convert.py`` is a rename. ``TransformerBlock`` keeps the JAX
gates' decisions, not their TPU conditions:

* serving (eval mode, autograd off): one fused kernel per sublayer on the
  card, K2 and K3, or K7 for a WF-adapted model; their plain versions for
  float32 models, CPU tensors and ``kernels=False``;
* training, or anything under autograd: the module path (Dense layers,
  attention, GELU, dropout), whose attention takes flash (K6 forward, K8
  backward) in bf16 at Tq >= ``flash_train_min_q`` and the einsum
  formulation otherwise;
* where K2's shared memory does not fit (d=1280), serving attention is K5,
  K6 and the out-projection plus residual kernel, all three hand-written
  (the TPU serves this shape with K2's head-group split); decoder blocks
  (causal mask or cache) keep the module path for attention, with K9 over
  head-major caches in a decode step;
* int8 serving (``quantized_copy``, the JAX package's ``dense_q`` trees):
  ``Int8Dense`` layers (K10 at decode-step row counts), int8 KV caches with
  per-position scales read by K9's int8 half; such a block never takes
  K2, K3 or K5, which read bf16 weights.

Serving copies (``cast_for_serving``) of the f32 weights in the compute
dtype are kept while the weights stay unchanged and rebuilt at their next
use when a weight changes or moves (``ServingCopy``).

Tensor parallelism (``parallel/tp.apply_tp``): a split block holds its
rank's heads (q/k/v columns, head-major decode caches of num_heads / tp
heads) and hidden columns, and its row layers' partial products are
summed over the model group before their bias and residual are added once.
``Dense`` carries its role (``tp_mode``); a serving block runs
``attention_partial`` / ``mlp_partial`` (the fused kernels' split forms:
K5 -> K6 or K2's first three launches, ``ln_fc1``, then the row-parallel
partial GEMM), the group's sum, and K2's or K3's epilogue on it; a WF
insert is folded into each rank's part of its weight first (the fold
commutes with the slice).
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as flash
from ..ops.decode_attention import KERNEL_TK, MAX_TQ, grouped_decode_attention
from ..ops.fused_attention import (
    attention_core_plain,
    attention_core_tp,
    attention_sublayer_fits,
    attention_sublayer_plain,
    attention_sublayer_wf_plain,
    attn_residual_after_sum,
    fold_wf,
    fused_attention_sublayer_packed,
    fused_attention_sublayer_wf,
    out_proj_residual,
    residual_after_sum,
    row_parallel_product,
    row_partial,
    row_partial_plain,
)
from ..ops.fused_mlp import (
    fused_ln_mlp_residual,
    fused_ln_qkv,
    fused_ln_mlp_residual_wf,
    ln_fc1,
    ln_fc1_plain,
    ln_mlp_residual_plain,
    ln_mlp_residual_wf_plain,
    ln_rows_plain,
    pack_qkv,
    qkv_gemm_plain,
)
from ..ops.numerics import full_f32, layer_norm
from ..ops.quant import (
    int8_decode_attention,
    int8_finish,
    int8_kv_write,
    int8_kv_write_plain,
    int8_matmul,
    int8_row_product,
    quantize_int8,
)
from ..utils.config import AdapterConfig

FUSED_MIN_T = 64  # decoder blocks fuse their MLP from this many query rows


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal (+-2 std) with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


# (dim, dtype, device) -> the longest table made so far; rows do not depend
# on the length, so a shorter table is its prefix, bit for bit
_POSITIONS: dict = {}


def sinusoidal_positions(
    length: int, dim: int, dtype: torch.dtype = torch.float32, device: str = "cpu"
) -> torch.Tensor:
    """[length, dim] table: first half sin, second half cos (Whisper layout),
    the JAX numpy formula including its /(dim//2 - 1). Kept on `device`
    in `dtype` and grown only for a longer length, so a forward at a length
    seen before copies nothing from the host (a host copy cannot be
    captured into a CUDA graph)."""
    if dim % 2:
        raise ValueError(f"positions need an even width, got {dim}")
    key = (dim, dtype, str(device))
    table = _POSITIONS.get(key)
    if table is None or table.shape[0] < length:
        log_timescale = np.log(10000.0) / (dim // 2 - 1)
        inv = np.exp(-log_timescale * np.arange(dim // 2))
        t = np.arange(length)[:, None] * inv[None, :]
        host = np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)
        table = _POSITIONS[key] = torch.from_numpy(host).to(device=device, dtype=dtype)
    return table[:length]


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, 1, 1, max_len] bool mask (True = valid)."""
    valid = torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
    return valid[:, None, None, :]


def banded_length_mask(lengths: torch.Tensor, max_len: int, left: int, right: int) -> torch.Tensor:
    """Length mask restricted to a (left, right) context band around each
    query: [B, 1, T, T], True where key j is valid and q - left <= j <= q +
    right (-1 = unbounded on that side). Its [.., T, T] shape sends a block
    to the module path of attention (the JAX package's general XLA path),
    never to K2 or flash, which read key lengths only."""
    mask = length_mask(lengths, max_len)
    pos = torch.arange(max_len, device=lengths.device)
    band = torch.ones(max_len, max_len, dtype=torch.bool, device=lengths.device)
    if left >= 0:
        band &= pos[None, :] >= pos[:, None] - left
    if right >= 0:
        band &= pos[None, :] <= pos[:, None] + right
    return mask & band[None, None]


class ServingCopy:
    """What `build` makes from some parameters (their serving-dtype copy),
    kept while those parameters stay as they are: an in-place change
    (load_state_dict, an optimizer step, an edit) moves a tensor's version,
    and a move to another device or a swap of ``.data`` its storage, so
    either rebuilds the copy at its next use."""

    def __init__(self):
        self.key = None
        self.value = None

    def get(self, dtype: torch.dtype, tensors, build):
        """-> build()'s result for `dtype` and these tensors as they are now."""
        key = (dtype, *((t.device, t.data_ptr(), 0 if t.is_inference() else t._version)
                        for t in tensors if t is not None))
        if key != self.key:
            self.value = None  # free the stale copy first
            with torch.no_grad():
                self.value = build()
            self.key = key
        return self.value


class Dense(nn.Module):
    """flax nn.Dense parameters (kernel [in, out], optional bias) and its
    module-path forward: compute-dtype operands, the product rounded to the
    compute dtype, then + bias. ``wf`` adds a WF insert (``adapter_wf``).
    ``forward`` takes ``kernels`` only because its callers also hold
    Int8Dense layers, whose switch it is; a bf16 Dense runs no kernel, save
    a row-parallel one (below).

    Split by ``parallel/tp.apply_tp`` (``tp`` set), it holds its rank's
    part: a column layer (``tp_mode`` "column") its output columns, a row
    layer its input rows, whose input is its rank's part of the features
    (``tp_input`` "local") or all of them, sliced here ("replicated": the
    Att adapter's out-projection). A row layer's partial product is f32
    (jl_row_partial on a bf16 CUDA tensor with ``kernels``), summed over
    the group, rounded once, then + bias. A WF insert stays whole and reads
    its rank's part: B's columns in a column layer, A's rows in a row
    layer (whose low-rank projection x A is summed over the group too)."""

    tp = None
    tp_mode = None
    tp_input = "local"

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator, bias: bool = True,
                 wf: Optional[AdapterConfig] = None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(d_in, d_out), d_in, gen))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        if wf is not None:
            from .adapters import WFAdapter

            self.adapter_wf = WFAdapter(wf, d_in, d_out, gen)
        self.serve_dtype = None  # set by cast_for_serving
        self._serve = ServingCopy()

    def cast_for_serving(self, dtype: torch.dtype) -> None:
        self.serve_dtype = dtype
        with torch.no_grad():
            self.weights(dtype)

    def weights(self, dtype: torch.dtype):
        """(kernel, bias): the serving copies when serving is in `dtype` and
        autograd is off, else the f32 parameters."""
        if self.serve_dtype != dtype or torch.is_grad_enabled():
            return self.kernel, self.bias
        return self._serve.get(dtype, (self.kernel, self.bias), lambda: (
            self.kernel.to(dtype), None if self.bias is None else self.bias.to(dtype)))

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if self.tp is not None:
            return self._tp_forward(x, kernels)
        kernel, bias = self.weights(x.dtype)
        y = torch.matmul(x, kernel.to(x.dtype))
        if bias is not None:
            y = y + bias.to(x.dtype)
        if hasattr(self, "adapter_wf"):
            y = self.adapter_wf(x, y)
        return y

    def _part(self, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        return t.narrow(dim, self.tp.rank * n, n)

    def _tp_forward(self, x: torch.Tensor, kernels: bool) -> torch.Tensor:
        tp, dt = self.tp, x.dtype
        kernel, bias = self.weights(dt)
        wf = getattr(self, "adapter_wf", None)
        if self.tp_mode == "column":
            x = tp.enter(x)
            y = torch.matmul(x, kernel.to(dt))
            if bias is not None:
                y = y + bias.to(dt)
            return y if wf is None else split_wf(tp, "column", wf, x, y, kernel.shape[1])
        n = kernel.shape[0]
        if self.tp_input == "replicated":
            x = self._part(tp.enter(x), -1, n)
        y = tp.reduce(row_parallel_product(x, kernel, kernels)).to(dt)
        if bias is not None:
            y = y + bias.to(dt)
        return y if wf is None else split_wf(tp, "row", wf, x, y, n)

    def insert(self) -> dict:
        """The WF insert {a, g, b} in the K7 wrappers' layout, cut to this
        rank's part of a split layer (B's columns, or A's rows), so that
        fold_wf(kernel, insert(), scale) is this rank's part of the whole
        layer's fold."""
        f = self.adapter_wf
        a, g, b = f.a, f.g, f.b
        if self.tp is not None and self.tp_mode == "column":
            b = self._part(b, 1, self.kernel.shape[1])
        elif self.tp is not None:
            a = self._part(a, 0, self.kernel.shape[0])
        return {"a": a, "g": g, "b": b}

    def quantized(self) -> "Int8Dense":
        """The int8 form; a WF insert stays beside it as it is (the JAX
        tree's ``adapter_wf`` beside ``dense_q``). A split layer keeps its
        role: a column layer quantizes its columns; a row layer its rows
        with each column's scale taken over the whole column (the group's
        largest |w|), so the ranks hold the unsplit layer's int8 rows."""
        with torch.no_grad():
            amax = None
            if self.tp is not None and self.tp_mode == "row":
                amax = self.tp.gather(self.kernel.abs().amax(dim=0)[None], 0).amax(dim=0)
            q, scale = quantize_int8(self.kernel, amax)
            out = Int8Dense(q, scale, None if self.bias is None else self.bias.detach().clone(),
                            getattr(self, "adapter_wf", None))
            out.tp, out.tp_mode, out.tp_input = self.tp, self.tp_mode, self.tp_input
            return out


def split_wf(tp, mode: str, wf, x: torch.Tensor, y: torch.Tensor, n: int) -> torch.Tensor:
    """y plus a whole WF insert's term on a split layer's rank (`n` its
    columns or rows): B's columns of this rank in a column layer; in a row
    layer A's rows, the low-rank projection x A summed over the group."""
    dt = x.dtype
    if mode == "column":
        z = torch.matmul(x, tp.enter(wf.a).to(dt)) * tp.enter(wf.g).to(dt)
        b = tp.enter(wf.b).narrow(1, tp.rank * n, n)
        return y + wf.scale * torch.matmul(z, b.to(dt))
    a = tp.enter(wf.a).narrow(0, tp.rank * n, n)
    z = tp.reduce(row_parallel_product(x, a, False)).to(dt) * wf.g.to(dt)
    return y + wf.scale * torch.matmul(z, wf.b.to(dt))


class Int8Dense(nn.Module):
    """The int8 serving form of a Dense layer (the JAX package's WFDense
    ``dense_q`` branch): buffers ``kernel_q`` int8 [in, out] and ``scale``
    f32 [out] (``quantize_int8``, per output channel) and the f32 ``bias``.
    y = int8_matmul(x, kernel_q, scale, bias) (K10 at decode-step row
    counts, the bias, kept as a serving copy in x's dtype, added in its
    epilogue; x's dtype out), then a WF insert's low-rank term when the
    layer was adapted (``adapter_wf``, its f32 parameters kept).

    Split (``tp``, ``tp_mode``, ``tp_input`` as Dense's): a column layer
    runs K10 on its columns with its part of the bias; a row layer's
    rank takes K10's row partial (``int8_row_product``: f32, unrounded,
    no bias), the group sums the partials, and the sum is rounded as
    int8_matmul rounds, then the bias is added once (``int8_finish``). A
    WF insert takes Dense's split route (``split_wf``)."""

    tp = None
    tp_mode = None
    tp_input = "local"

    def __init__(self, kernel_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], adapter_wf: Optional[nn.Module] = None):
        super().__init__()
        self.register_buffer("kernel_q", kernel_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)
        if adapter_wf is not None:
            self.adapter_wf = adapter_wf
        self._bias = ServingCopy()

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        dt = x.dtype
        bias = None if self.bias is None else self._bias.get(
            dt, (self.bias,), lambda: self.bias.to(dt))
        wf = getattr(self, "adapter_wf", None)
        tp = self.tp
        if tp is None or self.tp_mode == "column":
            y = int8_matmul(x, self.kernel_q, self.scale, kernels, bias)
            if wf is None:
                return y
            return wf(x, y) if tp is None else split_wf(tp, "column", wf, x, y,
                                                       self.kernel_q.shape[1])
        n = self.kernel_q.shape[0]
        if self.tp_input == "replicated":
            x = x.narrow(-1, tp.rank * n, n)
        y = int8_finish(tp.reduce(int8_row_product(x, self.kernel_q, self.scale, kernels)),
                        dt, bias)
        return y if wf is None else split_wf(tp, "row", wf, x, y, n)


def quantized_copy(module: nn.Module) -> nn.Module:
    """A copy of `module` for int8 serving: every backbone submodule with a
    ``quantized()`` form (Dense, the tied embedding) is replaced by it; the
    adapters (``adapter_*``: their Dense layers too, as the JAX package
    quantizes only the backbone's ``dense`` trees) and the other parameters
    and buffers are the same tensors, and serving copies start empty.
    `module` itself is left as it is."""
    if hasattr(module, "quantized"):
        return module.quantized()
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {n: m if m is None or n.startswith("adapter_") else quantized_copy(m)
                    for n, m in module._modules.items()}
    for name, value in vars(module).items():
        if isinstance(value, ServingCopy):
            setattr(new, name, ServingCopy())
    return new


def is_quantized(module: nn.Module) -> bool:
    """True when `module` holds int8 Dense layers (ModelBundle.quantize)."""
    return any(isinstance(m, Int8Dense) for m in module.modules())


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics, eps 1e-5, output in the input dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class Dropout(nn.Module):
    """flax nn.Dropout: in training keep each value with probability 1 - p
    and scale it by 1 / (1 - p). The masks come from generators on the
    input's device that live across steps, one for each draw the site
    makes in a step: the forward's and, under remat, the recompute's.
    Setting ``seed`` (the step's seed, on the host) or ``site`` (the site's
    index, set by the model) seeds all of them with (seed x 1,000,003 +
    site), so every draw of a step, and a forward recomputed for the
    backward, gives the same mask, as a generator made and seeded for each
    draw would. ``rewind`` starts a step's draws over without seeding:
    inside a CUDA graph capture nothing is made or seeded (the step's eager
    warm-up made the generators; every replay reads the seeds the host set
    since, ``seed_dropout``). On a tensor-parallel rank's hidden columns
    (``tp`` set by ``parallel/tp.apply_tp``) it draws the whole layer's
    mask and keeps its rank's columns, so every topology drops the same
    units."""

    tp = None

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generators: List[torch.Generator] = []
        self._site = 0
        self._seed: Optional[int] = None
        self.draws = 0

    @property
    def seed(self) -> Optional[int]:
        return self._seed

    @seed.setter
    def seed(self, value: Optional[int]) -> None:
        self._seed = value
        self._reseed()

    @property
    def site(self) -> int:
        return self._site

    @site.setter
    def site(self, value: int) -> None:
        self._site = value
        self._reseed()

    def _value(self) -> int:
        return (self._seed * 1_000_003 + self._site) % (2**63 - 1)

    def _reseed(self) -> None:
        self.draws = 0
        if self._seed is not None:
            for gen in self.generators:
                gen.manual_seed(self._value())

    def rewind(self) -> None:
        self.draws = 0

    def _generator(self, device: torch.device) -> torch.Generator:
        if self.generators and self.generators[0].device != device:
            self.generators = []
        if self.draws == len(self.generators):
            self.generators.append(torch.Generator(device=device).manual_seed(self._value()))
        gen = self.generators[self.draws]
        self.draws += 1
        return gen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        if self._seed is None:
            raise RuntimeError("dropout in training needs a step seed (model(..., dropout_seed=s))")
        gen = self._generator(x.device)
        if self.tp is None:
            keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.p
        else:
            n = x.shape[-1]
            whole = torch.rand(*x.shape[:-1], n * self.tp.size, generator=gen, device=x.device)
            keep = whole.narrow(-1, self.tp.rank * n, n) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


def arm_dropout(sites, seed: Optional[int]) -> None:
    """A model forward's dropout: with a seed, seed every site on the host;
    without one (a train step seeded them, ``seed_dropout``), start each
    site's draws over."""
    for m in sites:
        if seed is None:
            m.rewind()
        else:
            m.seed = seed


def seed_dropout(model: nn.Module, seed: int) -> None:
    """Seed every dropout site of `model` for one train step (host side,
    before the step runs or replays)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.seed = seed


def dropout_generators(model: nn.Module) -> List[torch.Generator]:
    """Every generator the model's dropout sites draw from (after a step
    made them), to register with a captured step."""
    return [g for m in model.modules() if isinstance(m, Dropout) for g in m.generators]


def dot_product_attention(q, k, v, mask=None, use_flash: bool = False, kv_lengths=None,
                          kernels: bool = True):
    """[B, T, H, dh] attention (the JAX function). mask: broadcastable to
    [B, H, Tq, Tk], True = attend; kv_lengths: [B] valid keys, the channel
    flash reads (a multi-row mask drops them). Flash (K6; K8 under
    autograd) takes bf16 at Tq >= 64 with dh in the kernels' widths and a
    key-validity mask at most; the rest is the einsum formulation with an
    f32 softmax."""
    if kv_lengths is not None and mask is not None and mask.shape[-2] != 1:
        kv_lengths = None
    key_mask_only = mask is None or (mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1)
    if (use_flash and q.shape[1] >= 64 and q.dtype == torch.bfloat16
            and q.shape[-1] in flash.HEAD_WIDTHS and key_mask_only):
        return flash.flash_attention(q, k, v, mask, kv_lengths=kv_lengths, kernels=kernels)
    if mask is None and kv_lengths is not None:
        mask = length_mask(torch.as_tensor(kv_lengths, device=q.device), k.shape[1])
    dt = q.dtype
    with full_f32():
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(dt)
        return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dt)


def update_cache_rows(cache: torch.Tensor, new: torch.Tensor, index, time_axis: int):
    """Write one decode step's K/V rows into `cache` at position `index`,
    in place (the JAX function returns an updated copy; here the caches
    are large and each step owns them), and return the cache. `index` an
    int (every row at one position) or a [B] tensor (per-row positions);
    packed [B, T, d] caches take time_axis=1, head-major [B, H, T, dh]
    caches and their [B, H, T] scale planes time_axis=2. `new`'s time axis
    has length 1."""
    new = new.to(cache.dtype)
    if isinstance(index, int) or (torch.is_tensor(index) and index.dim() == 0):
        cache.narrow(time_axis, int(index), 1).copy_(new)
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    index = index.to(cache.device, torch.int64)
    if time_axis == 1:
        cache[rows, index] = new[:, 0]
    elif time_axis == 2:
        heads = torch.arange(cache.shape[1], device=cache.device)
        cache[rows[:, None], heads[None, :], index[:, None]] = new[:, :, 0]
    else:
        raise ValueError(f"unsupported cache time_axis {time_axis}")
    return cache


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention, Whisper bias convention (k unbiased); WF
    inserts on all four projections when the adapter kind is "wf".

    Decode caches (the JAX module's two layouts): a head-major
    [B, H, T, dh] cache takes K9 for bf16 caches with kernels=True and
    threaded lengths, else the einsum formulation; an int8 head-major
    cache (``k_scale``/``v_scale`` beside ``k``/``v``) takes
    ``int8_cache_attention``; a packed [B, T, d] cache takes the einsum
    path. Cross-attention (``kv`` given) reads the cache as it is;
    self-attention writes this step's rows at ``cache_index`` first (int8:
    quantized per position)."""

    def __init__(self, d_model: int, num_heads: int, gen: torch.Generator, dropout: float = 0.0,
                 adapter: Optional[AdapterConfig] = None, use_flash: bool = True,
                 flash_train_min_q: int = 512):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of {num_heads} heads")
        wf = adapter if adapter is not None and adapter.kind == "wf" else None
        self.num_heads = num_heads  # this rank's heads once split (parallel/tp.py)
        self.head_dim = d_model // num_heads
        self.use_flash = use_flash
        self.flash_train_min_q = flash_train_min_q
        self.q_proj = Dense(d_model, d_model, gen, wf=wf)
        self.k_proj = Dense(d_model, d_model, gen, bias=False, wf=wf)
        self.v_proj = Dense(d_model, d_model, gen, wf=wf)
        self.out_proj = Dense(d_model, d_model, gen, wf=wf)
        self.dropout = Dropout(dropout) if dropout > 0 else None
        self._qkv = ServingCopy()

    def qkv_weights(self, dtype: torch.dtype):
        """K5's packed operands ([d, 3D] kernel, [3D] bias; ops/fused_mlp.pack_qkv)
        in `dtype`, kept between calls like the Dense serving copies. A
        tensor-parallel rank's are padded to a multiple of 128 columns (its
        3D may not be one); its callers pass D."""
        q, k, v = self.q_proj, self.k_proj, self.v_proj
        pad = 1 if q.tp is None else 128
        return self._qkv.get(dtype, (q.kernel, q.bias, k.kernel, v.kernel, v.bias),
                             lambda: pack_qkv(q.kernel, q.bias, k.kernel, v.kernel, v.bias, dtype,
                                              pad_to=pad))

    def forward(self, x: torch.Tensor, kv_lengths: Optional[torch.Tensor] = None,
                kernels: bool = True, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, kv_cache: Optional[dict] = None,
                cache_index=None, return_kv: bool = False):
        """Module path: x [B, Tq, d] (already layer-normed); kv [B, Tk, d]
        for cross-attention; mask broadcastable to [B, H, Tq, Tk] (True =
        attend); kv_lengths [B] valid keys, the channel the kernels read.
        -> out, (out, new_cache) with a cache, or {"k", "v"} with return_kv."""
        B, Tq, _ = x.shape
        H, dh = self.num_heads, self.head_dim
        kv_in = x if kv is None else kv
        if return_kv:  # cache precompute: the K/V projections of kv_in only
            return {"k": self.k_proj(kv_in, kernels), "v": self.v_proj(kv_in, kernels)}
        if kv_cache is not None and kv_cache["k"].dim() == 4:
            out, new_cache = self._head_major(x, kv, mask, kv_cache, cache_index, kv_lengths,
                                              kernels)
        else:
            q = self.q_proj(x, kernels)
            new_cache = None
            if kv_cache is not None and kv is not None:
                k, v = kv_cache["k"], kv_cache["v"]
                new_cache = kv_cache
            else:
                k, v = self.k_proj(kv_in, kernels), self.v_proj(kv_in, kernels)
                if kv_cache is not None:
                    k = update_cache_rows(kv_cache["k"], k, cache_index, 1)
                    v = update_cache_rows(kv_cache["v"], v, cache_index, 1)
                    new_cache = {"k": k, "v": v}
            Tk = k.shape[1]
            if kv_lengths is not None and mask is not None and mask.shape[-2] != 1:
                kv_lengths = None  # a multi-row (causal) mask carries what lengths cannot
            use_flash = self.use_flash and (not self.training or Tq >= self.flash_train_min_q)
            out = dot_product_attention(
                q.reshape(B, Tq, H, dh), k.reshape(B, Tk, H, dh), v.reshape(B, Tk, H, dh),
                mask, use_flash=use_flash, kv_lengths=kv_lengths, kernels=kernels,
            ).reshape(B, Tq, H * dh)
        out = self.out_proj(out, kernels)
        if self.dropout is not None:
            out = self.dropout(out)
        return out if kv_cache is None else (out, new_cache)

    def _head_major(self, x, kv, mask, kv_cache, cache_index, kv_lengths, kernels):
        """Decode step over [B, H, T, dh] caches -> ([B, Tq, H dh], new cache)."""
        B, Tq, _ = x.shape
        H, dh = self.num_heads, self.head_dim
        qh = self.q_proj(x, kernels).reshape(B, Tq, H, dh).transpose(1, 2)
        if kv is not None:  # cross-attention over the precomputed encoder K/V
            new_cache = kv_cache
        else:
            kh = self.k_proj(x, kernels).reshape(B, Tq, H, dh).transpose(1, 2)
            vh = self.v_proj(x, kernels).reshape(B, Tq, H, dh).transpose(1, 2)
            if "k_scale" in kv_cache:  # int8 self cache: this step's rows quantized (one launch)
                write = int8_kv_write if kernels else int8_kv_write_plain
                write(kh, vh, kv_cache, cache_index)
            else:
                update_cache_rows(kv_cache["k"], kh, cache_index, 2)
                update_cache_rows(kv_cache["v"], vh, cache_index, 2)
            new_cache = kv_cache
        k4, v4 = new_cache["k"], new_cache["v"]
        if "k_scale" in new_cache:
            o = int8_cache_attention(qh, k4, new_cache["k_scale"], v4, new_cache["v_scale"],
                                     kv_lengths, mask, x.dtype,
                                     t_enc=None if kv is None else kv.shape[1], kernels=kernels)
            return o.transpose(1, 2).reshape(B, Tq, H * dh), new_cache
        Tk = k4.shape[2]
        # lengths are threaded, never inferred from a mask (the JAX rule)
        if kv_lengths is not None:
            kv_lens = torch.broadcast_to(torch.as_tensor(kv_lengths, device=x.device), (B,))
        elif mask is None:
            kv_lens = torch.full((B,), min(kv.shape[1], Tk) if kv is not None else Tk,
                                 dtype=torch.int32, device=x.device)
        else:
            kv_lens = None
        if (kv_lens is not None and kernels and Tq <= MAX_TQ and Tk % KERNEL_TK == 0
                and k4.dtype == torch.bfloat16):
            o = grouped_decode_attention(qh, k4, v4, kv_lens).to(x.dtype)
        else:
            if kv_lens is not None:
                kmask = (torch.arange(Tk, device=x.device)[None, :]
                         < kv_lens.to(torch.int64)[:, None])[:, None, None, :]
            else:  # a general mask, False-padded out to the cache horizon
                kmask = F.pad(mask, (0, Tk - mask.shape[-1]), value=False)
            with full_f32():
                s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), k4.float()) * (1.0 / math.sqrt(dh))
                s = torch.where(kmask, s, torch.finfo(torch.float32).min)
                p = torch.softmax(s, dim=-1).to(x.dtype)
                o = torch.einsum("bhqk,bhkd->bhqd", p.float(), v4.float()).to(x.dtype)
        return o.transpose(1, 2).reshape(B, Tq, H * dh), new_cache

    def wf_params(self):
        """(base, inserts) in the K7 wrappers' layout (a split layer's part
        of each, ``Dense.insert``)."""
        base = {"wq": self.q_proj.kernel, "bq": self.q_proj.bias, "wk": self.k_proj.kernel,
                "wv": self.v_proj.kernel, "bv": self.v_proj.bias,
                "wo": self.out_proj.kernel, "bo": self.out_proj.bias}
        inserts = {n: p.insert() for n, p in (("q", self.q_proj), ("k", self.k_proj),
                                              ("v", self.v_proj), ("o", self.out_proj))}
        return base, inserts


def int8_cache_attention(qh, kq, ks, vq, vs, kv_lengths, mask, dtype, t_enc=None,
                         kernels: bool = True):
    """Decode-step attention over int8 head-major caches (the JAX package's
    ``layers._int8_cross_attention``): qh [B, H, Tq, dh]; kq/vq int8
    [B, H, Tk, dh]; ks/vs f32 [B, H, Tk]. Tk may be padded past the valid
    horizon `t_enc` (scales 0 there). Threaded lengths (or none and no
    mask: all `t_enc` keys) take K9's int8 half (its plain version with
    kernels=False). A decode step always threads its lengths and runs one
    query row, so a bare key mask or more than MAX_TQ rows raise, as K9's
    wrapper does on the card."""
    B, Tq = qh.shape[0], qh.shape[2]
    if kv_lengths is None and mask is not None:
        raise ValueError("int8 caches are read with threaded lengths, not a bare key mask")
    if Tq > MAX_TQ:
        raise ValueError(f"int8 decode attention takes at most {MAX_TQ} query rows, got {Tq}")
    if kv_lengths is None:  # filled on the device: no host copy, no sync
        Tk = kq.shape[2]
        kv_lens = torch.full((B,), Tk if t_enc is None else min(t_enc, Tk), dtype=torch.int32,
                             device=qh.device)
    else:
        kv_lens = torch.broadcast_to(
            torch.as_tensor(kv_lengths, device=qh.device).to(torch.int32), (B,))
    return int8_decode_attention(qh, kq, ks, vq, vs, kv_lens, kernels).to(dtype)


class MLP(nn.Module):
    """fc1 -> GELU (tanh or erf form) -> dropout -> fc2, WF inserts on both
    Dense layers when the adapter kind is "wf"."""

    def __init__(self, d_model: int, mlp_dim: int, gen: torch.Generator, gelu_form: str,
                 dropout: float = 0.0, adapter: Optional[AdapterConfig] = None):
        super().__init__()
        wf = adapter if adapter is not None and adapter.kind == "wf" else None
        self.fc1 = Dense(d_model, mlp_dim, gen, wf=wf)
        self.fc2 = Dense(mlp_dim, d_model, gen, wf=wf)
        self.gelu_form = gelu_form
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        h = F.gelu(self.fc1(x, kernels), approximate="tanh" if self.gelu_form == "tanh" else "none")
        if self.dropout is not None:
            h = self.dropout(h)
        return self.fc2(h, kernels)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHA(LN(x)), adapter slot, [x + cross-MHA(LN(x), enc)],
    x + MLP(LN(x)), slot."""

    def __init__(
        self, d_model: int, num_heads: int, mlp_dim: int, gen: torch.Generator,
        gelu_form: str = "erf", dropout: float = 0.0, adapter: Optional[AdapterConfig] = None,
        use_flash: bool = True, flash_train_min_q: int = 512, cross_attention: bool = False,
    ):
        super().__init__()
        from .adapters import KINDS, AdapterSlot

        ad = adapter or AdapterConfig()
        if ad.kind not in KINDS:
            raise ValueError(f"unknown adapter kind {ad.kind!r}")
        self.adapter = ad
        self.cross_attention = cross_attention
        self.self_attn_ln = LayerNorm(d_model)
        self.self_attn = MultiHeadAttention(d_model, num_heads, gen, dropout, ad, use_flash,
                                            flash_train_min_q)
        if cross_attention:
            self.cross_attn_ln = LayerNorm(d_model)
            self.cross_attn = MultiHeadAttention(d_model, num_heads, gen, dropout, ad, use_flash,
                                                 flash_train_min_q)
        self.mlp_ln = LayerNorm(d_model)
        self.mlp = MLP(d_model, mlp_dim, gen, gelu_form, dropout, ad)
        slots = ad.kind in ("bottleneck", "att")
        self.post_attn_slot = AdapterSlot(ad, d_model, gen) if slots and ad.after_attention else None
        self.post_mlp_slot = AdapterSlot(ad, d_model, gen) if slots and ad.after_mlp else None
        self._attn_fold = ServingCopy()  # a split WF block's folded operands
        self._mlp_fold = ServingCopy()

    def forward(
        self, x: torch.Tensor, kv_lengths: Optional[torch.Tensor] = None, kernels: bool = True,
        mask: Optional[torch.Tensor] = None, enc: Optional[torch.Tensor] = None,
        enc_mask: Optional[torch.Tensor] = None, self_cache: Optional[dict] = None,
        cross_cache: Optional[dict] = None, cache_index=None,
        enc_kv_lengths: Optional[torch.Tensor] = None, slot_caches: Optional[dict] = None,
    ):
        """x [B, T, d] in the compute dtype; kv_lengths [B] valid keys of the
        self-attention (frames, or pos + 1 in a decode step); mask a
        self-attention mask (the decoder's causal one); enc / enc_mask /
        enc_kv_lengths the cross-attention's keys; slot_caches the Att
        adapter slots' {"post_attn", "post_mlp"} caches in a decode step
        (written in place at cache_index). -> x, or (x, self_cache,
        cross_cache, slot_caches) when a cache is given (the JAX block's
        4-tuple)."""
        serve = not self.training and not torch.is_grad_enabled()
        # int8 Dense layers (ModelBundle.quantize) keep the module path: the
        # fused kernels read bf16 weights
        fused = serve and not isinstance(self.mlp.fc1, Int8Dense)
        if fused and mask is None and self_cache is None:
            x = self._serve_attention(x, kv_lengths, kernels)
        else:
            r = self.self_attn(self.self_attn_ln(x), kv_lengths, kernels, mask=mask,
                               kv_cache=self_cache, cache_index=cache_index)
            if self_cache is not None:
                r, self_cache = r
            x = x + r
        if self.post_attn_slot is not None:
            x = self._slot(self.post_attn_slot, "post_attn", x, kv_lengths, kernels, mask,
                           slot_caches, cache_index)
        if self.cross_attention:
            r = self.cross_attn(self.cross_attn_ln(x), enc_kv_lengths, kernels, kv=enc,
                                mask=enc_mask, kv_cache=cross_cache)
            if cross_cache is not None:
                r, cross_cache = r
            x = x + r
        # decode steps (a few query rows) keep the module path, as in the
        # JAX block's fused-MLP gate (x.shape[1] >= 64)
        if fused and (not self.cross_attention or x.shape[1] >= FUSED_MIN_T):
            x = self._serve_mlp(x, kernels)
        else:
            x = x + self.mlp(self.mlp_ln(x), kernels)
        if self.post_mlp_slot is not None:
            x = self._slot(self.post_mlp_slot, "post_mlp", x, kv_lengths, kernels, mask,
                           slot_caches, cache_index)
        if self_cache is not None or cross_cache is not None:
            return x, self_cache, cross_cache, slot_caches
        return x

    @staticmethod
    def _slot(slot, name, x, kv_lengths, kernels, mask, slot_caches, cache_index):
        """An adapter slot, over its own cache when the step carries one."""
        if slot_caches is None:
            return slot(x, kv_lengths, kernels, mask)
        return slot(x, kv_lengths, kernels, mask, slot_caches[name], cache_index)[0]

    def precompute_cross(self, enc: torch.Tensor) -> dict:
        """The cross-attention's K/V of an encoder output [B, T, d], once
        per utterance: {"k", "v"} [B, T, d]."""
        return self.cross_attn(enc, kv=enc, return_kv=True)

    def _serve_attention(self, x, kv_lengths, kernels: bool):
        """Fused self-attention sublayer. bf16 with kernels=True: K2 (K7 with
        WF inserts: the fold, then K2's launches) where K2's shared memory
        fits; else K5, then K6, then the out-projection plus residual kernel
        (the JAX block's long-context route, with its XLA product a kernel
        here; K7 runs them on the folded weights). Otherwise the plain
        version of K2 (K7)."""
        fused = kernels and x.dtype == torch.bfloat16
        sa, ln = self.self_attn, self.self_attn_ln
        if kv_lengths is None:
            kv_lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        tp = sa.q_proj.tp
        if tp is not None:
            acc = tp.reduce(self.attention_partial(x, kv_lengths, kernels))
            finish = attn_residual_after_sum if self._k2_route(x) else residual_after_sum
            return finish(x, acc, sa.out_proj.weights(x.dtype)[1])
        if self.adapter.kind == "wf":
            base, inserts = sa.wf_params()
            fn = fused_attention_sublayer_wf if fused else attention_sublayer_wf_plain
            return fn(x, ln.scale, ln.bias, base, inserts, sa.num_heads, ln.eps,
                      float(self.adapter.scale), kv_lengths)
        wo, bo = sa.out_proj.weights(x.dtype)
        if fused and not attention_sublayer_fits(x.shape[2], sa.num_heads):
            q, k, v = fused_ln_qkv(x, ln.scale, ln.bias, *sa.qkv_weights(x.dtype), ln.eps)
            attn = flash.flash_attention_packed(q, k, v, sa.num_heads, kv_lengths=kv_lengths)
            return out_proj_residual(x, attn, wo, bo)
        if fused:
            return fused_attention_sublayer_packed(x, ln.scale, ln.bias, *sa.qkv_weights(x.dtype),
                                                   wo, bo, kv_lengths, sa.num_heads, ln.eps)
        wq, bq = sa.q_proj.weights(x.dtype)
        wk, _ = sa.k_proj.weights(x.dtype)
        wv, bv = sa.v_proj.weights(x.dtype)
        return attention_sublayer_plain(x, ln.scale, ln.bias, wq, bq, wk, wv, bv, wo, bo,
                                        kv_lengths, sa.num_heads, ln.eps)

    def _k2_route(self, x) -> bool:
        """The card serves this split block's attention with K2's launches
        (else K5 -> K6 -> K2h-out): the whole layer fits K2, and the rank's
        packed q/k/v need no padding (K2's core reads them as [q | k | v])."""
        sa = self.self_attn
        return (attention_sublayer_fits(x.shape[2], sa.num_heads * sa.q_proj.tp.size)
                and 3 * sa.num_heads * sa.head_dim % 128 == 0)

    def _folded(self, dense: Dense, dtype: torch.dtype) -> torch.Tensor:
        """A split WF layer's serving kernel in `dtype`: its part with its
        part of the insert folded in (f32 fold, the K7 wrappers' ``fold_wf``)."""
        return fold_wf(dense.kernel, dense.insert(), float(self.adapter.scale)).to(dtype)

    @staticmethod
    def _kept_fold(copy: ServingCopy, dtype: torch.dtype, dense, build):
        """build()'s folded operands of these split WF layers, kept in `copy`
        while their kernels, biases and inserts stay as they are."""
        return copy.get(dtype, [t for d in dense for t in (
            d.kernel, d.bias, d.adapter_wf.a, d.adapter_wf.g, d.adapter_wf.b)], build)

    def _attention_weights(self, dtype: torch.dtype):
        """A split block's attention operands: (packed q/k/v kernel, its bias,
        wo), this rank's parts, WF inserts folded in."""
        sa = self.self_attn
        if self.adapter.kind != "wf":
            return (*sa.qkv_weights(dtype), sa.out_proj.weights(dtype)[0])
        dense = (sa.q_proj, sa.k_proj, sa.v_proj, sa.out_proj)

        def build():
            q, k, v = (self._folded(d, torch.float32) for d in dense[:3])
            return (*pack_qkv(q, sa.q_proj.bias, k, v, sa.v_proj.bias, dtype, pad_to=128),
                    self._folded(sa.out_proj, dtype))

        return self._kept_fold(self._attn_fold, dtype, dense, build)

    def _mlp_weights(self, dtype: torch.dtype):
        """A split block's (fc1, fc2) kernels, this rank's parts, WF inserts
        folded in."""
        m = self.mlp
        if self.adapter.kind != "wf":
            return m.fc1.weights(dtype)[0], m.fc2.weights(dtype)[0]
        return self._kept_fold(self._mlp_fold, dtype, (m.fc1, m.fc2), lambda: (
            self._folded(m.fc1, dtype), self._folded(m.fc2, dtype)))

    def attention_partial(self, x, kv_lengths, kernels: bool = True):
        """A tensor-parallel rank's f32 partial of the self-attention
        sublayer's out-projection, over its heads: bf16 with kernels=True,
        K2's route (``attention_core_tp``) or K5 -> K6, then
        ``row_partial``; otherwise the plain versions of those launches. The
        group's sum, rounded, plus the bias and x, is the sublayer
        (``_serve_attention``)."""
        fused = kernels and x.dtype == torch.bfloat16
        sa, ln = self.self_attn, self.self_attn_ln
        H, D = sa.num_heads, sa.num_heads * sa.head_dim
        w_qkv, b_qkv, wo = self._attention_weights(x.dtype)
        if not fused:
            qkv = qkv_gemm_plain(ln_rows_plain(x, ln.scale, ln.bias, ln.eps), w_qkv, b_qkv)
            return row_partial_plain(attention_core_plain(qkv[..., :3 * D], kv_lengths, H), wo)
        if self._k2_route(x):
            attn = attention_core_tp(x, ln.scale, ln.bias, w_qkv, b_qkv, kv_lengths, H, ln.eps)
        else:
            q, k, v = fused_ln_qkv(x, ln.scale, ln.bias, w_qkv, b_qkv, ln.eps, width=D)
            attn = flash.flash_attention_packed(q, k, v, H, kv_lengths=kv_lengths)
        return row_partial(attn, wo)

    def mlp_partial(self, x, kernels: bool = True):
        """A tensor-parallel rank's f32 partial of the MLP sublayer's fc2 over
        its hidden columns: ``ln_fc1`` then ``row_partial`` (bf16 with
        kernels=True), else their plain versions."""
        ln, m = self.mlp_ln, self.mlp
        (w1, w2), b1 = self._mlp_weights(x.dtype), m.fc1.weights(x.dtype)[1]
        if kernels and x.dtype == torch.bfloat16:
            return row_partial(ln_fc1(x, ln.scale, ln.bias, w1, b1, ln.eps, m.gelu_form), w2)
        return row_partial_plain(ln_fc1_plain(x, ln.scale, ln.bias, w1, b1, ln.eps, m.gelu_form),
                                 w2)

    def _serve_mlp(self, x, kernels: bool):
        """One fused sublayer: K3 (K7 with WF inserts) or its plain version;
        a split block's ``mlp_partial``, summed over the group, + b2 + x."""
        fused = kernels and x.dtype == torch.bfloat16
        ln, m = self.mlp_ln, self.mlp
        if m.fc1.tp is not None:
            acc = m.fc1.tp.reduce(self.mlp_partial(x, kernels))
            return residual_after_sum(x, acc, m.fc2.weights(x.dtype)[1])
        if self.adapter.kind == "wf":
            fn = fused_ln_mlp_residual_wf if fused else ln_mlp_residual_wf_plain
            return fn(x, ln.scale, ln.bias, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias,
                      m.fc1.insert(), m.fc2.insert(), ln.eps, m.gelu_form,
                      float(self.adapter.scale))
        fn = fused_ln_mlp_residual if fused else ln_mlp_residual_plain
        return fn(x, ln.scale, ln.bias, *m.fc1.weights(x.dtype), *m.fc2.weights(x.dtype),
                  ln.eps, m.gelu_form)


def cast_for_serving(model: nn.Module, dtype: torch.dtype) -> None:
    """Serve from a `dtype` copy of every Dense kernel and bias (and of tied
    embedding tables), made now and kept: without it each decode step casts
    every frozen f32 weight again. flax's Dense(dtype=bf16) casts the same
    way, so the numbers do not change. A copy is rebuilt at its next use
    after its weight changes or moves; training and autograd ignore the
    copies."""
    for m in model.modules():
        if hasattr(m, "cast_for_serving"):
            m.cast_for_serving(dtype)
