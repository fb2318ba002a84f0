"""K4 (csrc/head.cu: head GEMM tiles with an argmax epilogue, then a merge
of the tiles) and P2 (the same tiles with the argmax carried in the block
over 512-column chunks) against the JAX package's head + argmax kernel,
run in interpret mode on the CPU as the JAX package's own tests run it.

The CUDA kernels run only on the card. Here their reduction order is
emulated on the plain logits: each consumer thread's ascending,
strictly-greater scan over its 32 columns of a 128-column tile (the wgmma
accumulator layout), the quad merge (larger value, then lower column), and
then K4's ascending merge of the tiles or P2's running carry over
512-column chunks, both from (-inf, 0). Also: the wrappers' refusals, and
the CTC head's serving copy."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.ops import fused_head as jfh  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCHead  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_head as tfh  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import probes  # noqa: E402

# f32 logits of the two packages differ only by summation order (~1e-6 at
# d=512); ids are compared wherever the top-2 margin exceeds this
ARGMAX_MARGIN = 1e-3
TILE, CHUNK = 128, 512  # csrc/head.cu: a tile's columns, P2's chunk
V_FLAGSHIP = 4336


def _thread_scan(tile):
    """[M, 128] logits of one tile (-inf past V) -> the quad-merged (max,
    first column within the tile) per row. Thread q of a row's quad holds
    the columns 8 j + 2 q + e (j 0..15, e 0..1) and scans them in that,
    ascending, order with strict greater; torch.max returns the first
    maximal index, which is what that scan keeps."""
    M = tile.shape[0]
    by_thread = tile.reshape(M, TILE // 8, 4, 2).permute(0, 2, 1, 3).reshape(M, 4, TILE // 4)
    m, pos = by_thread.max(dim=-1)
    q = torch.arange(4)[None, :]
    col = 8 * (pos // 2) + 2 * q + pos % 2
    col = torch.where(torch.isinf(m) & (m < 0), torch.full_like(col, 2 ** 31 - 1), col)
    return _quad_merge(m, col)


def _quad_merge(m, col):
    """[M, 4] candidates -> [M] (larger value; the lower column on equal values)."""
    best = m.max(dim=-1, keepdim=True).values
    col = torch.where(m == best, col, torch.full_like(col, 2 ** 31 - 1))
    return best[:, 0], col.min(dim=-1).values


def _carry(best, best_i, m, col):
    """the strict running update of csrc/head.cu: only a greater max moves it"""
    upd = m > best
    return torch.where(upd, m, best), torch.where(upd, col, best_i)


def _padded(logits):
    V = logits.shape[1]
    return torch.nn.functional.pad(logits, (0, -V % CHUNK), value=-float("inf"))


def emulate_k4(logits):
    """[M, V] f32 -> int32 ids: per-tile (max, first column), then the
    merge launch's ascending strict scan over the tiles."""
    lp, V = _padded(logits), logits.shape[1]
    best = torch.full((logits.shape[0],), -float("inf"))
    best_i = torch.zeros(logits.shape[0], dtype=torch.int64)
    for n0 in range(0, V, TILE):
        m, col = _thread_scan(lp[:, n0:n0 + TILE])
        best, best_i = _carry(best, best_i, m, col + n0)
    return best_i.to(torch.int32)


def emulate_p2(logits):
    """[M, V] f32 -> int32 ids: each thread scans its columns of a chunk's
    four tiles in ascending order, the quad merges once a chunk, and the
    chunk's (max, first column) updates the running pair strictly."""
    lp, V = _padded(logits), logits.shape[1]
    M = logits.shape[0]
    best = torch.full((M,), -float("inf"))
    best_i = torch.zeros(M, dtype=torch.int64)
    for c0 in range(0, V, CHUNK):
        chunk = lp[:, c0:c0 + CHUNK].reshape(M, CHUNK // TILE, TILE // 8, 4, 2)
        by_thread = chunk.permute(0, 3, 1, 2, 4).reshape(M, 4, CHUNK // 4)
        m, pos = by_thread.max(dim=-1)  # first maximal position in scan order
        tile, rest = pos // (TILE // 4), pos % (TILE // 4)
        col = c0 + TILE * tile + 8 * (rest // 2) + 2 * torch.arange(4)[None, :] + rest % 2
        best, best_i = _carry(best, best_i, *_quad_merge(m, col))
    return best_i.to(torch.int32)


EMULATIONS = {"K4": emulate_k4, "P2": emulate_p2}


def _inputs(B, T, d, V, seed):
    rng = np.random.RandomState(seed)
    x = np.array(jnp.asarray(rng.randn(B, T, d), jnp.bfloat16).astype(jnp.float32))
    w = (rng.randn(d, V) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.randn(V)).astype(np.float32)
    return x, w, b


def _jax_ids(x, w, b):
    return np.asarray(jfh.fused_head_argmax(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                            jnp.asarray(b)))


def _plain_logits(x, w, b):
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return tfh.head_logits(xt, torch.from_numpy(w), torch.from_numpy(b))


@pytest.mark.parametrize("kernel", ["K4", "P2"])
@pytest.mark.parametrize("B,T,d,V", [(3, 37, 16, V_FLAGSHIP), (3, 37, 80, 700),
                                     (3, 37, 512, V_FLAGSHIP), (2, 40, 128, 100)],
                         ids=["d16", "d80", "d512", "v-below-a-tile"])
def test_emulated_kernel_matches_jax_kernel(kernel, B, T, d, V):
    x, w, b = _inputs(B, T, d, V, seed=d + V)
    want = _jax_ids(x, w, b)
    logits = _plain_logits(x, w, b)
    got = EMULATIONS[kernel](logits.reshape(B * T, V)).reshape(B, T)
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > ARGMAX_MARGIN).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    # on the same logits, the reduction order gives the first maximal index
    # everywhere, which is the plain argmax
    assert torch.equal(got, tfh.head_argmax_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w), torch.from_numpy(b)))


# duplicate columns (first, second) under a dominant bias tie on every frame:
# inside a tile, across a tile boundary, across P2's chunk boundary, far
# apart, inside the ragged last tile (V = 4336 = 33 x 128 + 112)
TIES = [(130, 250), (127, 128), (511, 512), (7, 4000), (4330, 4335)]


@pytest.mark.parametrize("first,second", TIES, ids=[f"{a}-{b}" for a, b in TIES])
def test_ties_go_to_the_first_index(first, second):
    x, w, b = _inputs(2, 16, 16, V_FLAGSHIP, seed=31)
    w[:, second] = w[:, first]
    b[first] = b[second] = 100.0
    assert (_jax_ids(x, w, b) == first).all()
    logits = _plain_logits(x, w, b).reshape(-1, V_FLAGSHIP)
    assert torch.equal(logits[:, first], logits[:, second])
    for emulate in EMULATIONS.values():
        assert (emulate(logits) == first).all()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for fn in (tfh.fused_head_argmax, probes.head_argmax_chunked):
        assert (fn(xt, torch.from_numpy(w), torch.from_numpy(b)) == first).all()


def test_plain_version_ignores_the_serving_copys_padding():
    """V = 300 is padded to 304 columns; the padding (zeros, which would win
    against negative logits) is never read."""
    x, w, b = _inputs(2, 16, 64, 300, seed=7)
    b -= 50.0  # every real logit negative
    xt = torch.from_numpy(x).to(torch.bfloat16)
    copy = tfh.serving_kernel(torch.from_numpy(w))
    assert copy.dtype == torch.bfloat16 and tuple(copy.shape) == (64, 304)
    assert copy.is_contiguous() and (copy[:, 300:] == 0).all()
    want = tfh.head_argmax_plain(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert int(want.max()) < 300
    for fn in (tfh.fused_head_argmax, probes.head_argmax_chunked):
        assert torch.equal(fn(xt, copy, torch.from_numpy(b)), want)


def _meta(*shape, dtype=torch.bfloat16, offset=0):
    n = offset + int(np.prod(shape))
    return torch.empty(n, device="meta", dtype=dtype)[offset:].view(*shape)


# (x, kernel, bias, the refusal's message): what the tensor maps and the
# kernels cannot take
REFUSED = {
    "d not a multiple of 16": ((1, 8, 120), (120, 256), (256,), "unsupported head shape"),
    "kernel rows not d": ((1, 8, 128), (64, 256), (256,), "unsupported head shape"),
    "bias wider than kernel": ((1, 8, 128), (128, 256), (264,), "unsupported head shape"),
    "empty vocabulary": ((1, 8, 128), (128, 256), (0,), "unsupported head shape"),
    "no rows": ((0, 8, 128), (128, 256), (256,), "unsupported head shape"),
    "bf16 rows not 16 bytes": ((1, 8, 128), (128, 300), (300,), "16-byte multiples"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
@pytest.mark.parametrize("wrapper", [tfh.fused_head_argmax, probes.head_argmax_chunked],
                         ids=["K4", "P2"])
def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, wrapper, name):
    xs, ks, bs, match = REFUSED[name]
    x, kernel, bias = _meta(*xs), _meta(*ks), _meta(*bs, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):  # a device with no kernel
        wrapper(x, kernel, bias)
    monkeypatch.setattr(tfh, "check_cuda", lambda *args: None)
    with pytest.raises(ValueError, match=match):
        wrapper(x, kernel, bias)


@pytest.mark.parametrize("wrapper", [tfh.fused_head_argmax, probes.head_argmax_chunked],
                         ids=["K4", "P2"])
@pytest.mark.parametrize("which", ["x", "kernel"])
def test_wrappers_refuse_misaligned_operands(monkeypatch, wrapper, which):
    """x and W are read through tensor maps, which need 16-byte aligned
    data: a view 8 bytes in is refused before any launch; a transposed
    (non-contiguous) bf16 kernel is refused as a layout."""
    monkeypatch.setattr(tfh, "check_cuda", lambda *args: None)
    ops = {"x": _meta(1, 8, 128), "kernel": _meta(128, 256)}
    ops[which] = _meta(*ops[which].shape, offset=4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wrapper(ops["x"], ops["kernel"], _meta(256, dtype=torch.float32))
    with pytest.raises(ValueError, match="16-byte multiples"):
        wrapper(_meta(1, 8, 128), _meta(256, 128).t(), _meta(256, dtype=torch.float32))


@pytest.mark.parametrize("key", ["K4", "P2"])
@pytest.mark.parametrize("d,V", [(16, 4336), (80, 100), (1024, 4336), (2048, 8)])
def test_wrappers_take_every_shape_the_kernels_take(monkeypatch, key, d, V):
    """Any d % 16 == 0 (no upper bound: k streams through the TMA ring) and
    any V, from an f32 kernel (copied per call) or a padded bf16 copy (read
    in place): every check passes and the C function gets the rows, d, V
    and the row pitch (K4 also its [ceil(V / 128), rows] partials)."""
    wrapper, symbol, counter = {
        "K4": (tfh.fused_head_argmax, "jl_head_argmax", tfh.COUNTER),
        "P2": (probes.head_argmax_chunked, "jl_head_argmax_chunked", probes.CHUNKED_COUNTER),
    }[key]
    calls = []
    monkeypatch.setattr(tfh, "check_cuda", lambda *args: None)
    for module in (tfh, probes):
        monkeypatch.setattr(module, "launch", lambda *args: calls.append(args))
    counter.reset()
    x = _meta(3, 37, d)
    for kernel in (_meta(d, V, dtype=torch.float32), _meta(d, -(-V // 8) * 8)):
        ids = wrapper(x, kernel, _meta(V, dtype=torch.float32))
        assert ids.dtype == torch.int32 and tuple(ids.shape) == (3, 37)
    pointers = 5 if key == "K4" else 4
    assert [c[0] for c in calls] == [symbol, symbol] and counter.launches == 2
    assert all(c[pointers + 1:] == (111, d, V, -(-V // 8) * 8) for c in calls)


def test_ctc_head_serves_from_one_kept_copy():
    """cast_for_serving makes the padded bf16 copy once; argmax_ids hands it
    to the head (the plain version here) with the same ids as the f32
    parameter; an in-place change of the parameter rebuilds it."""
    head = CTCHead(64, 300, torch.Generator().manual_seed(0))
    with torch.no_grad():
        head.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_inputs(2, 16, 64, 300, seed=3)[0]).to(torch.bfloat16)
    want = tfh.head_argmax_plain(x, head.kernel, head.bias)
    head.cast_for_serving(torch.bfloat16)
    with torch.no_grad():
        copy = head.weight(torch.bfloat16)
        assert copy.dtype == torch.bfloat16 and tuple(copy.shape) == (64, 304)
        assert head.weight(torch.bfloat16) is copy  # kept, not made again
        assert torch.equal(head.argmax_ids(x), want)
        assert head.weight(torch.float32) is head.kernel  # other dtypes: the parameter
        head.kernel.mul_(-1.0)
        rebuilt = head.weight(torch.bfloat16)
        assert rebuilt is not copy and torch.equal(rebuilt[:, :300],
                                                   head.kernel.to(torch.bfloat16))
        assert torch.equal(head.argmax_ids(x), tfh.head_argmax_plain(x, head.kernel, head.bias))
    assert head.weight(torch.bfloat16) is head.kernel  # autograd on: the parameter
