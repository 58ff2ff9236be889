"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the full-width serving shapes.  Skipped without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them (``tests/conftest.py`` imports JAX, hence
``--noconftest`` there):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: K1 1e-5 relative, each f32 probability against its own
|ref| (the softmax sums are reduced in another order); most of a row's
probabilities lie far below any useful absolute limit.  K3 2**-6 per
query row, max|out - ref| / max|ref|: two bf16 roundings of the output
(one ulp is 2**-7 of a value) plus P rounded to bf16 before P V, where
the plain version keeps f32.  A row's own scale keeps the limit strict
for the late rows of a long prompt, whose outputs are small.  K2 2**-6
per (row, head), max|out - ref| / max|ref| over head_dim: one bf16
rounding of the output (2**-8 relative at most, 2**-7 of a row maximum
just above a power of two) plus f32 sums in another order; parked rows
are held to zeros instead, which the kernel writes for them (their
output is never read).  K4 and K5 1e-5 per row, max|out - ref| /
max|ref|: f32 sums of up to 16,384 products in another order; rows
without an adapter are held to exact zeros, and K5 on one-hot gate rows
to K4's output bit for bit.  K6: y per (batch, position) row,
max|out - ref| / max|ref| over d_inner, 2**-7 in bf16 (the kernel and
the plain version round their f32 y to bf16 separately, one ulp at
most) and 1e-5 in f32; h_final 1e-5 of its max (f32 recurrences whose
updates round once more in the plain version); its chunk states the
same.  K8 (causal and windowed, head_dim 256, 112 and 32) 2**-6 of each
gradient's max; K10 1e-5 on its f32 gradients (d(dt), dA) and 2**-7 on
its bf16 ones (dx, dB, dC; 1e-5 in f32).  K11 (the SSD scan): y per (batch, position, head)
row, max|out - ref| / max|ref| over P, 1e-4, and h_final 1e-5 of its
max: the kernel runs the f32 recurrence step by step, the plain version
the reference's chunk form (exponentials of cumulative log-decay
differences over up to 256 steps), which part by ~1.4e-5 per row at S
1,536 on the CPU in f32.  K11's chunk states 1e-5 of their max.  K12
(the SSD scan's backward) 1e-4 of each gradient's max on d(dt) and da
and on every gradient in f32, 2**-7 on its bf16 dx, dB and dC (one
rounding): K12 runs the f32 recurrence, the plain version autograd
through the chunk form, as K11 against its plain version.  K3 at
head_dim 112 as at 256, and with a window no shorter than S equal to
causal bit for bit; K3 and K8 at head_dim 64 (granite-moe: H 24 over
KV 8, a group of 3) as at 256.  K7: ids and perturbed
scores equal to the plain version's bit for bit (the kernel computes
the plain version's integer and float steps, each rounded the same
way)."""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as K3
from repro_torch.kernels.logit_fusion import kernel as K1
from repro_torch.kernels.logit_fusion import sample as K7
from repro_torch.kernels.moe_lora import kernel as KL
from repro_torch.kernels.paged_attention import kernel as K2
from repro_torch.kernels.ssm_scan import kernel as K6
from repro_torch.kernels.ssd_scan import kernel as K11

FREED_POS = 1 << 30
NO_PAGE = 1 << 20


def row_rel_err(out, ref):
    """max over rows (the last axis) of max|out - ref| / max|ref|."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fuse_logits_matches_plain(cuda, b, dtype):
    g = torch.Generator(device=cuda).manual_seed(b)
    sl = (3 * torch.randn(b, 256_000, device=cuda, generator=g)).to(dtype)
    ll = (3 * torch.randn(b, 256_000, device=cuda, generator=g)).to(dtype)
    w = torch.rand(b, device=cuda, generator=g)
    arrived = torch.tensor([True, False, True, False][:b], device=cuda)
    before = K1.fuse_logits.launches
    out = K1.fuse_logits(sl, ll, w, arrived)
    torch.cuda.synchronize()
    assert K1.fuse_logits.launches == before + 1
    ref = K1.fuse_logits_plain(sl, ll, w, arrived)
    assert ((out - ref).abs() / ref.abs()).max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("v", [256_000, 1_001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [False, True])
def test_fuse_logits_split_v(cuda, b, v, dtype, mask):
    """Split-V over (chunks, B): the ragged V = 1,001 takes the
    element-wise path; two calls give the same bits, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(b * v)
    sl = (3 * torch.randn(b, v, device=cuda, generator=g)).to(dtype)
    ll = (3 * torch.randn(b, v, device=cuda, generator=g)).to(dtype)
    w = torch.rand(b, device=cuda, generator=g)
    arrived = torch.tensor([True, False, True, False, False, True, True,
                            False][:b], device=cuda) if mask else None
    before = K1.fuse_logits.launches
    out = K1.fuse_logits(sl, ll, w, arrived)
    again = K1.fuse_logits(sl, ll, w, arrived)
    torch.cuda.synchronize()
    assert K1.fuse_logits.launches == before + 2
    assert torch.equal(out, again)
    ref = K1.fuse_logits_plain(sl, ll, w, arrived)
    assert ((out - ref).abs() / ref.abs()).max().item() <= 1e-5


@pytest.mark.gpu
def test_fuse_logits_takes_any_w_and_arrived_dtype(cuda):
    """One contract on both devices: a bf16 w and an int32 arrived give
    what the plain version gives, as the f32 w and bool arrived do."""
    g = torch.Generator(device=cuda).manual_seed(2)
    sl = 3 * torch.randn(2, 1_000, device=cuda, generator=g)
    ll = 3 * torch.randn(2, 1_000, device=cuda, generator=g)
    w = torch.rand(2, device=cuda, generator=g).bfloat16()
    arrived = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    out = K1.fuse_logits(sl, ll, w, arrived)
    same = K1.fuse_logits(sl, ll, w.float(), arrived.bool())
    ref = K1.fuse_logits_plain(sl, ll, w, arrived)
    assert torch.equal(out, same)
    assert ((out - ref).abs() / ref.abs()).max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh", [(8, 1), (16, 16)])
@pytest.mark.parametrize("s,window", [(31, 0), (200, 64), (2048, 0),
                                      (2048, 512)])
def test_flash_attention_matches_plain(cuda, h, kvh, s, window):
    g = torch.Generator(device=cuda).manual_seed(s + h)
    q = torch.randn(1, h, s, 256, device=cuda, generator=g).bfloat16()
    k = torch.randn(1, kvh, s, 256, device=cuda, generator=g).bfloat16()
    v = torch.randn(1, kvh, s, 256, device=cuda, generator=g).bfloat16()
    before = K3.flash_attention.launches
    out = K3.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert K3.flash_attention.launches == before + 1
    ref = K3.flash_attention_plain(q, k, v, window=window)
    assert row_rel_err(out, ref) <= 2 ** -6


def k3_inputs(dev, g, b, h, kvh, s, d, layout="bhsd"):
    """bf16 q, k, v as (B, H, S, D) tensors, or as the model hands them
    over: (B, H, S, D) views of (B, S, H, D) projections."""
    if layout == "bhsd":
        return [torch.randn(b, n, s, d, device=dev, generator=g).bfloat16()
                for n in (h, kvh, kvh)]
    return [torch.randn(b, s, n, d, device=dev, generator=g).bfloat16()
            .transpose(1, 2) for n in (h, kvh, kvh)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh", [(8, 1), (16, 16)])
def test_flash_attention_admission_burst(cuda, h, kvh):
    """The packed admission prefill of the batched engine: B = 8 rows of
    1,552 positions, the SLM and the LLM geometry."""
    g = torch.Generator(device=cuda).manual_seed(h)
    q, k, v = k3_inputs(cuda, g, 8, h, kvh, 1552, 256)
    out = K3.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert row_rel_err(out, K3.flash_attention_plain(q, k, v)) <= 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("s,window", [(31, 0), (200, 64), (1000, 0)])
@pytest.mark.parametrize("h,kvh", [(4, 1), (4, 2)])
def test_flash_attention_head_dim_32(cuda, s, window, h, kvh):
    """head_dim 32, the reduced configs the check phases run."""
    g = torch.Generator(device=cuda).manual_seed(s + h + kvh)
    q, k, v = k3_inputs(cuda, g, 2, h, kvh, s, 32)
    out = K3.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    ref = K3.flash_attention_plain(q, k, v, window=window)
    assert row_rel_err(out, ref) <= 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,kvh,s", [(256, 16, 16, 1552), (256, 8, 1, 700),
                                       (32, 4, 2, 129)])
def test_flash_attention_reads_strided_views(cuda, d, h, kvh, s):
    """(B, H, S, D) views of (B, S, H, D) tensors are read in place and
    give the bits the contiguous copies give; the output's transpose is
    contiguous."""
    g = torch.Generator(device=cuda).manual_seed(d + s)
    views = k3_inputs(cuda, g, 2, h, kvh, s, d, layout="bshd")
    out = K3.flash_attention(*views)
    dense = K3.flash_attention(*(t.contiguous() for t in views))
    torch.cuda.synchronize()
    assert out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, dense)
    assert row_rel_err(out, K3.flash_attention_plain(*views)) <= 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 777])
@pytest.mark.parametrize("h,kvh,window", [(16, 16, 0), (8, 1, 0),
                                          (16, 16, 100)])
def test_flash_attention_ragged_lengths(cuda, s, h, kvh, window):
    """S not a multiple of the 64-key or 128-query tile: rows past S are
    zero-filled on load, masked, and never stored."""
    g = torch.Generator(device=cuda).manual_seed(s + h + window)
    q, k, v = k3_inputs(cuda, g, 2, h, kvh, s, 256)
    out = K3.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    ref = K3.flash_attention_plain(q, k, v, window=window)
    assert row_rel_err(out, ref) <= 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_non_causal(cuda, causal):
    g = torch.Generator(device=cuda).manual_seed(int(causal))
    q, k, v = k3_inputs(cuda, g, 1, 8, 2, 300, 256)
    out = K3.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = K3.flash_attention_plain(q, k, v, causal=causal)
    assert row_rel_err(out, ref) <= 2 ** -6


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn(2, 16, 8, 256, device=cuda)           # f32, not bf16
    with pytest.raises(TypeError):
        K3.flash_attention(x, x, x)
    with pytest.raises(ValueError):
        K3.flash_attention(x.bfloat16()[..., :48], x.bfloat16()[..., :48],
                           x.bfloat16()[..., :48])         # head_dim 48
    z = torch.randn(2, 100, device=cuda)
    with pytest.raises(ValueError):
        K1.fuse_logits(z, z, torch.ones(3, device=cuda))  # w not (B,)


def paged_case(dev, g, b, h, kvh, hd, n_pool, nb, window, positions):
    """A pool of random bf16 pages and block tables as the allocator
    builds them: a live plain row maps the pages its position needs
    (NO_PAGE past that), a ring row a full ring of window / 16 pages; a
    parked row (pos = FREED_POS) maps nothing."""
    ps = 16
    q = torch.randn(b, h, hd, device=dev, generator=g).bfloat16()
    pk = torch.randn(n_pool, ps, kvh, hd, device=dev, generator=g).bfloat16()
    pv = torch.randn(n_pool, ps, kvh, hd, device=dev, generator=g).bfloat16()
    free = torch.randperm(n_pool, device=dev, generator=g).tolist()
    table = torch.full((b, nb), NO_PAGE, dtype=torch.int32)
    for i, p in enumerate(positions):
        if p >= FREED_POS:
            continue
        n = window // ps if window else p // ps + 1
        table[i, :n] = torch.tensor([free.pop() for _ in range(n)])
    pos = torch.tensor(positions, dtype=torch.int32)
    return q, pk, pv, table.to(dev), pos.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,hd", [(8, 1, 256), (16, 16, 256),
                                      (4, 1, 32), (4, 2, 32)])
@pytest.mark.parametrize("window", [0, 512])
def test_paged_attention_matches_plain(cuda, h, kvh, hd, window):
    positions = [0, 15, 16, 700, 1541, 2047, FREED_POS, 1541]
    nb = window // 16 if window else 128
    g = torch.Generator(device=cuda).manual_seed(h + kvh + window)
    case = paged_case(cuda, g, 8, h, kvh, hd, 1024, nb, window, positions)
    before = K2.paged_decode_attention.launches
    out = K2.paged_decode_attention(*case, window=window)
    torch.cuda.synchronize()
    assert K2.paged_decode_attention.launches == before + 1
    ref = K2.paged_decode_attention_plain(*case, window=window)
    live = [i for i, p in enumerate(positions) if p < FREED_POS]
    assert row_rel_err(out[live], ref[live]) <= 2 ** -6
    assert torch.isfinite(out.float()).all()
    assert not out[positions.index(FREED_POS)].any()   # parked: zeros


@pytest.mark.gpu
def test_paged_attention_raises_instead_of_falling_back(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, pk, pv, table, pos = paged_case(cuda, g, 2, 8, 1, 256, 16, 4, 0,
                                       [3, 40])
    with pytest.raises(TypeError):
        K2.paged_decode_attention(q.float(), pk.float(), pv.float(), table,
                                  pos)
    with pytest.raises(TypeError):
        K2.paged_decode_attention(q, pk, pv, table.long(), pos)
    with pytest.raises(ValueError):                       # page_size 8
        K2.paged_decode_attention(q, pk.reshape(32, 8, 1, 256),
                                  pv.reshape(32, 8, 1, 256), table, pos)


def split_edge_positions(kvh, nb=128):
    """Positions just before, at and after the first two split edges of
    the kernel's split layout for B = 8 rows (the layout depends on the
    static shapes alone)."""
    splits = K2._lib().paged_decode_splits(8, kvh, nb, 0, 0)
    span = -(-nb // splits) * 16                      # slots per split
    return [span - 1, span, span + 15, 2 * span - 1, 2 * span,
            2 * span + 16, FREED_POS, span - 16]


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,hd", [(8, 1, 256), (16, 16, 256),
                                      (4, 1, 32), (4, 2, 32)])
@pytest.mark.parametrize("kind", ["split_edges", "all_short", "all_full",
                                  "window"])
def test_paged_attention_split_k(cuda, h, kvh, hd, kind):
    """The split-K design against its plain version: rows whose live
    pages end just before, at and after split edges, every row short (a
    single split each), every row at 2,047, and window mode on ring
    tables with young rows; parked rows are zeros and a second call on
    the same inputs returns the same bits."""
    window = 512 if kind == "window" else 0
    positions = {
        "split_edges": split_edge_positions(kvh),
        "all_short": [0, 1, 3, 5, 9, 15, 16, 17],
        "all_full": [2047] * 8,
        "window": [0, 100, 511, 512, 513, 2047, FREED_POS, 600],
    }[kind]
    nb = window // 16 if window else 128
    g = torch.Generator(device=cuda).manual_seed(len(kind) + h + hd)
    case = paged_case(cuda, g, 8, h, kvh, hd, 1024, nb, window, positions)
    before = K2.paged_decode_attention.launches
    out = K2.paged_decode_attention(*case, window=window)
    again = K2.paged_decode_attention(*case, window=window)
    torch.cuda.synchronize()
    assert K2.paged_decode_attention.launches == before + 2
    assert torch.equal(out, again)                      # bit for bit
    ref = K2.paged_decode_attention_plain(*case, window=window)
    live = [i for i, p in enumerate(positions) if p < FREED_POS]
    parked = [i for i, p in enumerate(positions) if p >= FREED_POS]
    assert row_rel_err(out[live], ref[live]) <= 2 ** -6
    assert torch.isfinite(out.float()).all()
    assert not out[parked].any()


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,hd", [(4, 1, 256), (4, 2, 32)])
@pytest.mark.parametrize("positions", [
    [0, 100, 511, 512, 513, 1541, FREED_POS, 2047],
    [600, 777, 1024, 1300, 1541, 1800, 2000, 2047]])
def test_paged_attention_window_over_full_table(cuda, h, kvh, hd,
                                                positions):
    """K2's full-length window mode (``ring=False``): window 512 over
    (8, 128) block tables mapped up to each row's position, at the
    gemma3 SLM's decode shape and a reduced one, rows below, at and past
    the window (one parked) or all past it; against the plain version,
    parked rows zeros, two calls bit-equal, counted as window launches
    and not as ring ones."""
    g = torch.Generator(device=cuda).manual_seed(h + hd + positions[0])
    case = paged_case(cuda, g, 8, h, kvh, hd, 1024, 128, 0, positions)
    counts = (K2.paged_decode_attention.window_launches,
              K2.paged_decode_attention.ring_launches)
    out = K2.paged_decode_attention(*case, window=512, ring=False)
    again = K2.paged_decode_attention(*case, window=512, ring=False)
    torch.cuda.synchronize()
    assert (K2.paged_decode_attention.window_launches,
            K2.paged_decode_attention.ring_launches) == (counts[0] + 2,
                                                         counts[1])
    assert torch.equal(out, again)
    ref = K2.paged_decode_attention_plain(*case, window=512, ring=False)
    live = [i for i, p in enumerate(positions) if p < FREED_POS]
    parked = [i for i, p in enumerate(positions) if p >= FREED_POS]
    assert row_rel_err(out[live], ref[live]) <= 2 ** -6
    assert torch.isfinite(out.float()).all()
    assert not out[parked].any()


@pytest.mark.gpu
def test_paged_attention_ring_at_gemma3_shape(cuda):
    """K2's ring mode at the gemma3 SLM's decode shape: B = 8, H 4, KV 1,
    hd 256, ring-local tables (8, 32) over 512-slot rings, rows at
    ragged depths before and past the window (one parked); two calls
    give the same bits."""
    positions = [0, 100, 511, 512, 513, 1541, FREED_POS, 2047]
    g = torch.Generator(device=cuda).manual_seed(41)
    case = paged_case(cuda, g, 8, 4, 1, 256, 1024, 32, 512, positions)
    before = K2.paged_decode_attention.launches
    out = K2.paged_decode_attention(*case, window=512)
    again = K2.paged_decode_attention(*case, window=512)
    torch.cuda.synchronize()
    assert K2.paged_decode_attention.launches == before + 2
    assert torch.equal(out, again)
    ref = K2.paged_decode_attention_plain(*case, window=512)
    live = [i for i, p in enumerate(positions) if p < FREED_POS]
    assert row_rel_err(out[live], ref[live]) <= 2 ** -6
    assert not out[positions.index(FREED_POS)].any()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [512, 0])
def test_flash_attention_at_gemma3_burst(cuda, window):
    """K3 at the gemma3 SLM's admission burst, (8, 4, 1552, 256) with one
    KV head, on (B, H, S, D) views of (B, S, H, D) projections: windowed
    (its 22 local layers) and causal (its 4 global ones)."""
    g = torch.Generator(device=cuda).manual_seed(43 + window)
    q, k, v = k3_inputs(cuda, g, 8, 4, 1, 1552, 256, layout="bshd")
    out = K3.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    ref = K3.flash_attention_plain(q, k, v, window=window)
    assert row_rel_err(out, ref) <= 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,p,s,window", [
    (8, 16, 16, 1001, 48, 0),          # COW suffix, the LLM
    (8, 8, 1, 1001, 48, 0),            # COW suffix, the 2b SLM
    (1, 16, 16, 2048, 1456, 0),        # final chunk at width 2,048
    (1, 8, 1, 2048, 1456, 0),          # the 2b SLM's final chunk
    (1, 16, 16, 1536, 512, 0),         # middle chunk at width 512
    (8, 4, 1, 1001, 48, 512),          # gemma3 SLM suffix, windowed
    (8, 4, 1, 1001, 48, 0),            # gemma3 SLM suffix, global
    (1, 4, 1, 1024, 512, 512),         # gemma3 middle chunk, windowed
    (1, 4, 1, 3072, 512, 512),         # a chunk far past the window
    (3, 4, 2, 37, 50, 16),             # ragged history
])
def test_flash_attention_history_offset(cuda, b, h, kvh, p, s, window):
    """K3's history-offset mode: queries at P + i over [history; fresh],
    a B = 1 history read in place by every row, on (B, H, S, D) views of
    (B, S, H, D) projections; counted apart."""
    g = torch.Generator(device=cuda).manual_seed(p + s)
    q, k, v = k3_inputs(cuda, g, b, h, kvh, s, 256, layout="bshd")
    hk, hv = k3_inputs(cuda, g, 1, kvh, kvh, p, 256, layout="bshd")[1:]
    before = (K3.flash_attention.launches, K3.flash_attention.offset_launches)
    out = K3.flash_attention(q, k, v, window=window, hist_k=hk, hist_v=hv)
    torch.cuda.synchronize()
    assert (K3.flash_attention.launches, K3.flash_attention.offset_launches
            ) == (before[0] + 1, before[1] + 1)
    ref = K3.flash_attention_plain(q, k, v, window=window, hist_k=hk,
                                   hist_v=hv)
    assert row_rel_err(out, ref) <= 2 ** -6


def lora_case(dev, g, t, k, n, e=4, r=16):
    x = torch.randn(t, k, device=dev, generator=g).bfloat16()
    a = torch.randn(e, r, k, device=dev, generator=g) / k ** 0.5
    b = torch.randn(e, n, r, device=dev, generator=g)
    return x, a, b


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 256), (2048, 32768),
                                 (16384, 2048)])
def test_moe_lora_kernels_match_plain(cuda, k, n):
    g = torch.Generator(device=cuda).manual_seed(k + n)
    x, a, b = lora_case(cuda, g, 8, k, n)
    slots = torch.tensor([0, 1, 2, 3, -1, 0, 2, -1], dtype=torch.int32,
                         device=cuda)
    before = (KL.moe_lora_delta_slots.launches, KL.moe_lora_delta.launches)
    k4 = KL.moe_lora_delta_slots(x, a, b, slots)
    one_hot = torch.nn.functional.one_hot(slots.clamp(min=0).long(), 4)
    one_hot = (one_hot * (slots >= 0)[:, None]).float()
    k5_hot = KL.moe_lora_delta(x, a, b, one_hot)
    soft = torch.rand(8, 4, device=cuda, generator=g)
    soft[3] = 0.0
    k5 = KL.moe_lora_delta(x, a, b, soft)
    torch.cuda.synchronize()
    assert (KL.moe_lora_delta_slots.launches,
            KL.moe_lora_delta.launches) == (before[0] + 1, before[1] + 2)
    live = slots >= 0
    assert row_rel_err(k4[live], KL.moe_lora_delta_slots_plain(
        x, a, b, slots)[live]) <= 1e-5
    assert not k4[~live].any() and not k5[3].any()
    assert torch.equal(k5_hot, k4)                      # bit for bit
    ref = KL.moe_lora_delta_plain(x, a, b, soft)
    rows = [i for i in range(8) if i != 3]
    assert row_rel_err(k5[rows], ref[rows]) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("t,rows_per", [(1, 1), (3, 1), (8, 1), (8, 2),
                                        (31, 31), (31, 1), (63, 3),
                                        (63, 1)])
@pytest.mark.parametrize("k,n", [(2048, 256), (16384, 2048)])
def test_moe_lora_decode_rows(cuda, t, rows_per, k, n):
    """The decode design (K4, and K5 below 64 rows) at T in {1, 3, 8,
    31, 63}: slots with repeats, adapter-free rows and slots past the
    bank (clamped onto E - 1), rows_per_slot / rows_per_gate > 1; K4 and
    K5 against their plain versions, K5 on the slots' one-hot gate rows
    equal to K4 bit for bit, and repeat calls bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(t + rows_per + k)
    x, a, b = lora_case(cuda, g, t, k, n)
    sel = ([0, 1, 2, 3, -1, 0, 5, -1, 2, 9, 2] * 8)[:t // rows_per]
    slots = torch.tensor(sel, dtype=torch.int32, device=cuda)
    k4 = KL.moe_lora_delta_slots(x, a, b, slots, rows_per)
    k4_again = KL.moe_lora_delta_slots(x, a, b, slots, rows_per)
    hot = hot_gates(cuda, [min(s, 3) for s in sel])
    k5_hot = KL.moe_lora_delta(x, a, b, hot, rows_per)
    soft = torch.rand(len(sel), 4, device=cuda, generator=g)
    if len(sel) > 1:
        soft[-1] = 0.0
    k5 = KL.moe_lora_delta(x, a, b, soft, rows_per)
    k5_again = KL.moe_lora_delta(x, a, b, soft, rows_per)
    torch.cuda.synchronize()
    assert torch.equal(k4, k4_again) and torch.equal(k5, k5_again)
    assert torch.equal(k5_hot, k4)                      # bit for bit
    live = slots.repeat_interleave(rows_per) >= 0
    ref4 = KL.moe_lora_delta_slots_plain(x, a, b, slots, rows_per)
    assert row_rel_err(k4[live], ref4[live]) <= 1e-5
    assert not k4[~live].any()
    zero = (soft == 0).all(1).repeat_interleave(rows_per)
    ref5 = KL.moe_lora_delta_plain(x, a, b, soft, rows_per)
    assert row_rel_err(k5[~zero], ref5[~zero]) <= 1e-5
    assert not k5[zero].any()


@pytest.mark.gpu
def test_moe_lora_admission_shape_matches_plain(cuda):
    """K5 at a packed admission prefill: 8 requests x 1,552 positions,
    one gate row per request (rows_per_gate = 1,552)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x, a, b = lora_case(cuda, g, 8 * 1552, 2048, 2048)
    gates = torch.rand(8, 4, device=cuda, generator=g)
    out = KL.moe_lora_delta(x, a, b, gates, rows_per_gate=1552)
    torch.cuda.synchronize()
    ref = KL.moe_lora_delta_plain(x, a, b, gates, rows_per_gate=1552)
    assert row_rel_err(out, ref) <= 1e-5


def hot_gates(dev, slots, e=4):
    """One-hot gate rows of adapter slots; a negative slot is a zero row."""
    s = torch.tensor(slots, device=dev)
    return (torch.nn.functional.one_hot(s.clamp(min=0), e)
            * (s >= 0)[:, None]).float()


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(2048, 32768), (16384, 2048)])
def test_moe_lora_admission_one_hot_gates(cuda, k, n):
    """serve_adapters' admission prefill: 8 requests x 1,552 positions,
    each request's one-hot gate row (two without an adapter)."""
    g = torch.Generator(device=cuda).manual_seed(k)
    x, a, b = lora_case(cuda, g, 8 * 1552, k, n)
    slots = [0, 3, -1, 1, 2, -1, 0, 3]
    gates = hot_gates(cuda, slots)
    out = KL.moe_lora_delta(x, a, b, gates, rows_per_gate=1552)
    torch.cuda.synchronize()
    ref = KL.moe_lora_delta_plain(x, a, b, gates, rows_per_gate=1552)
    live = torch.tensor(slots, device=cuda).repeat_interleave(1552) >= 0
    assert row_rel_err(out[live], ref[live]) <= 1e-5
    assert not out[~live].any()


@pytest.mark.gpu
@pytest.mark.parametrize("t,rows_per_gate", [(1200, 100), (1000, 1000),
                                             (77, 77), (333, 1), (64, 8)])
def test_moe_lora_gemm_path_tiles(cuda, t, rows_per_gate):
    """T >= 64 with tiles that straddle gate rows (rows_per_gate 100,
    1, 8), ragged T (1000, 77, 333), zero and one-hot gate rows among
    soft ones, at both k of the LoRA targets."""
    g = torch.Generator(device=cuda).manual_seed(t)
    for k, n in ((2048, 256), (16384, 2048)):
        x, a, b = lora_case(cuda, g, t, k, n)
        gates = torch.rand(t // rows_per_gate, 4, device=cuda, generator=g)
        gates[::3] = hot_gates(cuda, [1])
        gates[1::5] = 0.0
        out = KL.moe_lora_delta(x, a, b, gates, rows_per_gate=rows_per_gate)
        torch.cuda.synchronize()
        ref = KL.moe_lora_delta_plain(x, a, b, gates,
                                      rows_per_gate=rows_per_gate)
        zero = (gates == 0).all(1).repeat_interleave(rows_per_gate)
        assert row_rel_err(out[~zero], ref[~zero]) <= 1e-5
        assert not out[zero].any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2048, 16384])
def test_moe_lora_zero_gate_skip_is_bit_identical(cuda, k):
    """An expert whose gate is 0 over a whole tile is skipped; the result
    equals, bit for bit, that of a bank without the expert — on tiles
    that skip it (uniform gate rows) and on tiles that straddle gate rows
    and multiply it by 0."""
    g = torch.Generator(device=cuda).manual_seed(k)
    for rows_per_gate in (1552, 100):
        t = 8 * rows_per_gate
        x, a, b = lora_case(cuda, g, t, k, 2048)
        gates = torch.rand(8, 4, device=cuda, generator=g) + 0.1
        gates[:, 2] = 0.0
        gates[3] = hot_gates(cuda, [1])
        keep = [0, 1, 3]
        out = KL.moe_lora_delta(x, a, b, gates, rows_per_gate=rows_per_gate)
        without = KL.moe_lora_delta(x, a[keep].contiguous(),
                                    b[keep].contiguous(),
                                    gates[:, keep].contiguous(),
                                    rows_per_gate=rows_per_gate)
        torch.cuda.synchronize()
        assert torch.equal(out, without)


@pytest.mark.gpu
def test_moe_lora_raises_instead_of_falling_back(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, a, b = lora_case(cuda, g, 4, 64, 32, e=2, r=4)
    slots = torch.tensor([0, 1, -1, 0], device=cuda)        # int64
    with pytest.raises(TypeError):
        KL.moe_lora_delta_slots(x, a, b, slots)
    with pytest.raises(TypeError):
        KL.moe_lora_delta(x, a.bfloat16(), b, torch.ones(4, 2, device=cuda))
    with pytest.raises(TypeError):                           # f32 x
        KL.moe_lora_delta(x.float(), a, b, torch.ones(4, 2, device=cuda))
    with pytest.raises(ValueError):                          # r % 4 != 0
        KL.moe_lora_delta(x, a[:, :3], b[..., :3].contiguous(),
                          torch.ones(4, 2, device=cuda))


def ssm_case(dev, g, b, s, di, n, dtype, dt_rank=256, x_offset=0):
    """Inputs of one Mamba-1 prefill scan as the model hands them over:
    dt a softplus, B and C column slices of an x_proj-like output
    (b, s, dt_rank + 2n), A = -exp(A_log)."""
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, di, device=dev, generator=g) - 1.0)
    x = torch.randn(b * s * di + x_offset, device=dev,
                    generator=g).to(dtype)[x_offset:].view(b, s, di)
    xdbc = torch.randn(b, s, dt_rank + 2 * n, device=dev,
                       generator=g).to(dtype)
    bm, cm = xdbc[..., dt_rank:dt_rank + n], xdbc[..., dt_rank + n:]
    a = -torch.exp(0.5 * torch.randn(di, n, device=dev, generator=g))
    return dt, x, bm, cm, a


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,di,n,dtype", [
    (1, 1536, 8192, 16, torch.bfloat16),   # the serving prefill
    (1, 37, 8192, 16, torch.bfloat16),     # a short, odd prompt
    (1, 1, 8192, 16, torch.bfloat16),
    (2, 203, 520, 8, torch.float32),       # ragged di, reduced N
])
def test_ssm_scan_matches_plain(cuda, b, s, di, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + n)
    case = ssm_case(cuda, g, b, s, di, n, dtype)
    assert s == 1 or not case[2].is_contiguous()   # strided B and C
    before = K6.ssm_scan.launches
    y, h = K6.ssm_scan(*case)
    torch.cuda.synchronize()
    assert K6.ssm_scan.launches == before + 1
    ry, rh = K6.ssm_scan_plain(*case)
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert row_rel_err(y, ry) <= tol
    assert ((h - rh).abs().max() / rh.abs().max()).item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", [(1, 27), (2, 27), (2, 2048)])
def test_ssm_scan_full_width_repeats(cuda, b, s):
    """falcon-mamba-7b's width at a short prompt's S and at Bt = 2, S =
    2,048: within the limits, and two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(s + b)
    case = ssm_case(cuda, g, b, s, 8192, 16, torch.bfloat16)
    y, h = K6.ssm_scan(*case)
    y2, h2 = K6.ssm_scan(*case)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    ry, rh = K6.ssm_scan_plain(*case)
    assert row_rel_err(y, ry) <= 2 ** -7
    assert ((h - rh).abs().max() / rh.abs().max()).item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,di,n,dtype", [
    (4, 40, 8192, 16, torch.bfloat16),
    (1, 1536, 8192, 16, torch.bfloat16),
    (2, 203, 520, 8, torch.float32),
])
def test_ssm_scan_chunk_states(cuda, b, s, di, n, dtype):
    """K6 with its chunk-state output: y and h_final the same bits as
    without it, the states entering each 64-step chunk within 1e-5 of the
    plain scan's (zeros for the first)."""
    g = torch.Generator(device=cuda).manual_seed(s + 1)
    case = ssm_case(cuda, g, b, s, di, n, dtype)
    y, h = K6.ssm_scan(*case)
    y2, h2, hc = K6.ssm_scan(*case, chunk_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    _, _, rhc = K6.ssm_scan_plain(*case, chunk_states=True)
    assert hc.shape == rhc.shape == (b, -(-s // 64), di, n)
    assert not hc[:, 0].any()
    if s > 64:                  # states past the first chunk
        assert ((hc - rhc).abs().max() / rhc.abs().max()).item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,di,n,dtype", [
    (4, 40, 8192, 16, torch.bfloat16),     # a client step
    (2, 256, 8192, 16, torch.bfloat16),    # two 128-token chunks
    (1, 1536, 8192, 16, torch.bfloat16),
    (2, 203, 520, 8, torch.float32),       # ragged di and S, reduced N
])
def test_ssm_scan_bwd_matches_plain(cuda, b, s, di, n, dtype):
    """K10 from K6's chunk states against its plain version: d(dt) and
    dA (f32) within 1e-5 of their max (f32 sums in another order); dx, dB
    and dC within 2**-7 in bf16 (each rounds its f32 sum to bf16 once,
    one ulp at most) and 1e-5 in f32; two calls give the same bits; with
    no dA wanted the rest is unchanged."""
    g = torch.Generator(device=cuda).manual_seed(s + n)
    case = ssm_case(cuda, g, b, s, di, n, dtype)
    dy = torch.randn(b, s, di, device=cuda, generator=g).to(dtype)
    _, _, hc = K6.ssm_scan(*case, chunk_states=True)
    before = K6.ssm_scan_bwd.launches
    got = K6.ssm_scan_bwd(*case, dy, hc)
    again = K6.ssm_scan_bwd(*case, dy, hc)
    no_da = K6.ssm_scan_bwd(*case, dy, hc, need_da=False)
    torch.cuda.synchronize()
    assert K6.ssm_scan_bwd.launches == before + 3
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert no_da[4] is None
    assert all(torch.equal(x, y) for x, y in zip(got[:4], no_da[:4]))
    ref = K6.ssm_scan_bwd_plain(*case, dy)
    low = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for x, y, tol in zip(got, ref, (1e-5, low, low, low, 1e-5)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert rel(x, y) <= tol


@pytest.mark.gpu
def test_ssm_scan_train_takes_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    case = [t.detach().clone().requires_grad_(True)
            for t in ssm_case(cuda, g, 2, 128, 8192, 16, torch.bfloat16)]
    before = (K6.ssm_scan.launches, K6.ssm_scan_bwd.launches)
    K6.ssm_scan_train(*case).float().square().sum().backward()
    assert (K6.ssm_scan.launches, K6.ssm_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in case)


@pytest.mark.gpu
@pytest.mark.parametrize("di,dt_rank,x_offset,dtype", [
    (37, 5, 0, torch.bfloat16),        # di % 8 != 0, B/C unaligned
    (8192, 256, 1, torch.bfloat16),    # x 2 bytes off 16-byte alignment
    (100, 3, 0, torch.float32),
])
def test_ssm_scan_element_paths(cuda, di, dt_rank, x_offset, dtype):
    """Shapes and pointers the 16-byte copies cannot take move element by
    element, with the same results."""
    g = torch.Generator(device=cuda).manual_seed(di)
    case = ssm_case(cuda, g, 2, 77, di, 16, dtype, dt_rank, x_offset)
    y, h = K6.ssm_scan(*case)
    torch.cuda.synchronize()
    ry, rh = K6.ssm_scan_plain(*case)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert row_rel_err(y, ry) <= tol
    assert ((h - rh).abs().max() / rh.abs().max()).item() <= 1e-5


@pytest.mark.gpu
def test_ssm_scan_raises_instead_of_falling_back(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt, x, bm, cm, a = ssm_case(cuda, g, 1, 8, 64, 16, torch.bfloat16)
    with pytest.raises(TypeError):                       # bf16 dt
        K6.ssm_scan(dt.bfloat16(), x, bm, cm, a)
    with pytest.raises(TypeError):                       # mixed types
        K6.ssm_scan(dt, x.float(), bm, cm, a)
    with pytest.raises(ValueError):                      # N = 5
        K6.ssm_scan(dt, x, bm[..., :5], cm[..., :5], a[:, :5].contiguous())
    with pytest.raises(ValueError):                      # strided x
        K6.ssm_scan(dt[:, ::2].contiguous(), x[:, ::2], bm[:, ::2],
                    cm[:, ::2], a)
    gappy = torch.randn(1, 8, 32, device=cuda).bfloat16()[..., ::2]
    with pytest.raises(ValueError):                      # B strided over N
        K6.ssm_scan(dt, x, gappy, cm, a)


def k7_case(cuda, b, v, seed):
    """Probabilities with near-flat rows (softmax of 0.1 randn) and
    peaked ones (softmax of 8 randn), key ids past int32's range and
    negative, and a greedy mask mixing both kinds of row."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    scale = torch.tensor([0.1, 8.0] * b, device=cuda)[:b, None]
    probs = torch.softmax(scale * torch.randn(b, v, device=cuda,
                                              generator=g), -1)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (b,), device=cuda,
                         generator=g, dtype=torch.int64).to(torch.int32)
    steps = torch.randint(0, 4096, (b,), device=cuda, generator=g,
                          dtype=torch.int64).to(torch.int32)
    greedy = torch.tensor([False, False, True] * b, device=cuda)[:b]
    return probs, greedy, keys, steps


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("v", [512, 256_000])
def test_sample_fused_matches_plain(cuda, b, v):
    """K7's ids and scores equal the plain version's bit for bit, with
    and without a greedy mask, for a seed past 2**32 too; two calls give
    the same bits, one launch each."""
    probs, greedy, keys, steps = k7_case(cuda, b, v, b * v)
    for seed, mask in ((0, None), (7, greedy), (2 ** 32 + 9, greedy)):
        before = K7.sample_fused.launches
        ids, sc = K7.sample_fused(probs, mask, keys, steps, seed,
                                  scores=True)
        again = K7.sample_fused(probs, mask, keys, steps, seed)
        torch.cuda.synchronize()
        assert K7.sample_fused.launches == before + 2
        assert ids.dtype == torch.int64 and torch.equal(ids, again)
        ref_ids, ref_sc = K7.sample_fused_plain(probs, mask, keys, steps,
                                                seed, scores=True)
        assert torch.equal(ids, ref_ids)
        assert torch.equal(sc.view(torch.int32), ref_sc.view(torch.int32))


@pytest.mark.gpu
def test_sample_fused_raises_instead_of_falling_back(cuda):
    probs, greedy, keys, steps = k7_case(cuda, 2, 512, 0)
    with pytest.raises(ValueError):                      # bf16 probs
        K7.sample_fused(probs.bfloat16(), greedy, keys, steps, 0)
    with pytest.raises(ValueError):                      # strided probs
        K7.sample_fused(probs[:, ::2], greedy, keys, steps, 0)
    with pytest.raises(TypeError):                       # float key ids
        K7.sample_fused(probs, greedy, keys.float(), steps, 0)
    with pytest.raises(ValueError):                      # host steps
        K7.sample_fused(probs, greedy, keys, steps.cpu(), 0)
    with pytest.raises(ValueError):                      # (B+1,) greedy
        K7.sample_fused(probs, torch.ones(3, dtype=torch.bool,
                                          device=cuda), keys, steps, 0)


MACRO_PROMPTS = [
    "math: compute 12 plus 7 =",
    "my ssn is 123-45-6789, fill the benefits form",       # private
    "translate to french: water ->",
    "my doctor said my blood pressure is 140 over 90",     # private
    "sort ascending: 40 12 77 31 ->",
    "explain how rainbows form",
]
MACRO_BUDGETS = [9, 7, 4, 10, 11, 6]


@pytest.mark.gpu
def test_macro_graph_replay_equals_eager_body(cuda):
    """The K-token macro step on the reduced pair in bf16: two engines
    serve the same requests, one replaying each lane's CUDA graph, the
    other running the same body K times eagerly on the card.  Finished
    requests, pending logits and traces are bit-equal after every macro;
    both count the same kernel launches (the graph's replay-aware), K2
    once per decode layer of every iteration of a non-idle lane; the
    static buffers keep their addresses across replays."""
    macro_graph_vs_eager(cuda, "2b")


@pytest.mark.gpu
def test_macro_graph_replay_equals_eager_body_gemma3(cuda):
    """The same on the reduced gemma3 pair: the graph writes the ring
    leaves through the lanes' local tables (K2 in ring mode) and keeps
    the local pools and tables at their addresses."""
    macro_graph_vs_eager(cuda, "gemma3")


@pytest.mark.gpu
def test_sampled_macro_graph_replay_equals_eager_body(cuda):
    """The same with odd requests sampled (seeds 2000 + i): the cloud
    lane replays its sampled graph while a sampled row is live and its
    greedy graph after, the edge lane only its sampled one; both sides
    draw the same ids through K7 and count the same launches, and the
    lane's tensors, the sampling key ids and greedy flags included, keep
    their addresses across greedy and sampled replays."""
    macro_graph_vs_eager(cuda, "2b", sampled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("pair,ring", [("2b", True), ("gemma3", True),
                                       ("gemma3", False)])
@pytest.mark.parametrize("k", [0, 4])
def test_dense_lanes_equal_paged_on_the_card(cuda, pair, ring, k):
    """Dense lanes (``paged=False``: stacked rows that K2 reads in place
    as pages through identity tables) against paged lanes on the card,
    the reduced pairs in bf16, per-token and macro step: every response
    bit for bit (token ids, counts, latencies, fusion weights) and the
    same K2 launches by mode.  The gemma3 SLM runs with rings (K2's ring
    mode) and without (its full-length window mode)."""
    from repro_torch.data import tokenizer as TOK
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    dep = reduced_bf16_deployment(cuda, pair, ring)
    runs = []
    decode, TOK.decode = TOK.decode, lambda ids: ",".join(map(str, ids))
    try:
        for paged in (True, False):
            sched = ContinuousBatchScheduler.from_deployment(
                dep, batch_size=4, edge_batch_size=2, macro_k=k,
                paged=paged)
            for p, n in zip(MACRO_PROMPTS, MACRO_BUDGETS):
                sched.submit(p, n)
            fn = K2.paged_decode_attention
            fn.launches = fn.ring_launches = fn.window_launches = 0
            res = sched.run()
            torch.cuda.synchronize()
            runs.append(([(r.text, r.stats.tokens, r.stats.cloud_tokens,
                           r.stats.latency_ms, r.stats.fusion_w)
                          for r in res],
                         (fn.launches, fn.ring_launches,
                          fn.window_launches)))
    finally:
        TOK.decode = decode
    assert runs[0] == runs[1]
    launches, ring_n, window_n = runs[0][1]
    assert launches > 0
    assert (ring_n > 0, window_n > 0) == (pair == "gemma3" and ring,
                                          pair == "gemma3" and not ring)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", ["2b", "gemma3"])
def test_faulted_macro_graph_replay_equals_eager_body(cuda, pair):
    """The macro step on a lossy link (loss 0.25, outage 3 of every 10
    steps, breaker n 2 m 3): the breaker's update runs inside the cloud
    lane's graph, and the graph's finished requests (fault accounting
    included), traces and pending logits equal the eager body's."""
    macro_graph_vs_eager(cuda, pair, fault=CHAOS)


@pytest.mark.gpu
@pytest.mark.parametrize("pair,fault", [("2b", None), ("2b", "chaos"),
                                        ("gemma3", None)])
def test_spec_chain_graph_replay_equals_eager_body(cuda, pair, fault):
    """The speculative burst chain (spec_k 2, macro_k 4: two bursts a
    dispatch) replayed from the cloud lane's CUDA graph against the same
    bursts run eagerly on the card: finished requests, traces, pending
    logits, ``lt`` and the caches' positions bit-equal after every
    dispatch, the same kernel launches (K2 (k + 1) x SLM + k x LLM
    layers a burst), and the lane's tensors at fixed addresses."""
    from repro_torch.serving.engine import BatchedHybridEngine

    dep = reduced_bf16_deployment(cuda, pair,
                                  fault=CHAOS if fault else None)
    k, macro_k = 2, 4
    graph, eager = (BatchedHybridEngine(deployment=dep, batch_size=4,
                                        edge_batch_size=2, macro_k=macro_k,
                                        spec_k=k) for _ in range(2))
    reqs = [(p, n + 8, True, i)
            for i, (p, n) in enumerate(zip(MACRO_PROMPTS, MACRO_BUDGETS))]
    for eng in (graph, eager):
        assert eng.add_requests(reqs) == [True] * len(reqs)
    g, e = graph.cloud_lane, eager.cloud_lane
    chain = e.spec_chain(2, k)
    chain.run = lambda sample=False, c=chain: [c.body(t, sample)
                                               for t in range(c.n_bursts)]
    g.spec_chain(2, k)
    per_burst = (k + 1) * dep.slm.cfg.num_layers \
        + k * dep.llm.cfg.num_layers

    def addresses():
        return [t.data_ptr() for t in (g.sl, g.ll, g.lt, g.s_cache["pos"],
                                       g.l_cache["pos"],
                                       g._spec_chain.traces)]
    ptrs = None
    while graph.active_count() or eager.active_count():
        got = []
        for eng in (graph, eager):
            K2.paged_decode_attention.launches = 0
            out = eng.step()
            torch.cuda.synchronize()
            got.append(([(rid, text, st.tokens, st.latency_ms, st.fusion_w,
                          st.degraded_tokens, st.spec_accepted)
                         for rid, text, st in out],
                        K2.paged_decode_attention.launches))
        assert got[0] == got[1]
        assert torch.equal(g._spec_chain.traces, e._spec_chain.traces)
        for a, b in ((g.sl, e.sl), (g.lt, e.lt), (g.s_cache["pos"],
                                                  e.s_cache["pos"]),
                     (g.l_cache["pos"], e.l_cache["pos"])):
            assert torch.equal(a, b)
        ptrs = ptrs or addresses()
        assert addresses() == ptrs
    assert g._spec_chain.per_replay(K2.paged_decode_attention) \
        == 2 * per_burst
    assert g._spec_chain.replays >= 2 and e._spec_chain.replays == 0
    if fault:
        assert graph.health_stats() == eager.health_stats()
        assert graph.health_stats()["breaker_trips"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("macro_k", [0, 8])
def test_spec_equals_per_token_on_the_card(cuda, macro_k):
    """On the reduced 2b pair in bf16 (every request admitted in one
    burst), spec_k 4 emits the spec_k = 0 run's token ids and counts at
    the same macro_k, with fewer cloud calls."""
    from repro_torch.data import tokenizer as TOK
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    # calm weather: every reply arrives, so a burst's one draw equals
    # the per-token draws it stands for
    dep = reduced_bf16_deployment(cuda, "2b", latency=dict(
        rtt_ms=50.0, jitter_ms=5.0, cloud_compute_ms=20.0, seed=7))
    runs = []
    decode, TOK.decode = TOK.decode, lambda ids: ",".join(map(str, ids))
    try:
        for spec_k in (0, 4):
            sched = ContinuousBatchScheduler.from_deployment(
                dep, batch_size=4, edge_batch_size=2, macro_k=macro_k,
                spec_k=spec_k)
            for p, n in zip(MACRO_PROMPTS, MACRO_BUDGETS):
                sched.submit(p, n + 8)
            res = sched.run()
            runs.append(([(r.text, r.stats.tokens, r.stats.cloud_tokens)
                          for r in res],
                         sum(r.stats.cloud_calls for r in res)))
    finally:
        TOK.decode = decode
    assert runs[1][0] == runs[0][0]
    assert runs[1][1] < runs[0][1]


CHAOS = dict(loss_rate=0.25, outage_period=10, outage_len=3, seed=3,
             breaker_n=2, breaker_m=3)


def reduced_bf16_deployment(cuda, pair, ring=True, fault=None,
                            latency=None):
    """The reduced ``pair`` in bf16 on the card, max_seq 96, jittery
    weather (or the LatencyModel fields ``latency``); the gemma3 SLM with
    or without ring caches; ``fault`` the fields of a FaultModel, or
    None."""
    import dataclasses

    from repro_torch.configs.floe_pair import needs_ring_cache, pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.latency import FaultModel, LatencyModel

    scfg, lcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in pair_configs(pair))
    slm = LM(scfg, device=cuda, ring_cache=ring and needs_ring_cache(scfg))
    llm = LM(lcfg, device=cuda)
    return ServingDeployment(
        slm, slm.init(0), llm, llm.init(1),
        FUS.init_alignment(2, scfg.vocab_size, device=cuda),
        latency=LatencyModel(**(latency or dict(
            rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7))),
        max_seq=96, fault=FaultModel(**fault) if fault else None,
        device=cuda)


def macro_graph_vs_eager(cuda, pair, sampled=False, fault=None):
    from repro_torch.serving.engine import BatchedHybridEngine

    dep = reduced_bf16_deployment(cuda, pair, fault=fault)
    scfg, lcfg = dep.slm.cfg, dep.llm.cfg
    k = 4
    graph, eager = (BatchedHybridEngine(deployment=dep, batch_size=4,
                                        edge_batch_size=2, macro_k=k)
                    for _ in range(2))
    reqs = [(p, n, not (sampled and i % 2), i, 2000 + i)
            for i, (p, n) in enumerate(zip(MACRO_PROMPTS, MACRO_BUDGETS))]
    for eng in (graph, eager):
        assert eng.add_requests(reqs) == [True] * len(reqs)
    lanes = [(g, e) for g, e in ((graph.cloud_lane, eager.cloud_lane),
                                 (graph.edge_lane, eager.edge_lane))]
    for g, e in lanes:
        # build (and capture) both sides before counting: the warm-up
        # iteration of a capture launches kernels of its own
        g.macro(k).prepare(sampled)
        m = e.macro(k)
        m.prepare(sampled)
        m.run = lambda sample=False, m=m: [m.body(t, sample)
                                           for t in range(m.k)]
    layers = {True: scfg.num_layers + lcfg.num_layers,
              False: scfg.num_layers}

    def buffers():
        return [t.data_ptr() for lane, _ in lanes
                for m in (lane._macro,)
                for t in (m.ok, m.steps, m.max_new, m.done, m.traces,
                          m.key_ids, m.greedy, lane.sl, lane.s_cache["pos"],
                          lane.s_cache["block"],
                          lane.s_cache.get("local", lane.sl))]

    ptrs = None
    while graph.active_count() or eager.active_count():
        busy = [lane.active > 0 for lane, _ in lanes]
        want = sum(k * layers[lane.use_cloud]
                   for (lane, _), b in zip(lanes, busy) if b)
        got = []
        for eng in (graph, eager):
            K2.paged_decode_attention.launches = 0
            K7.sample_fused.launches = 0
            out = eng.step()
            torch.cuda.synchronize()
            got.append((out, K2.paged_decode_attention.launches,
                        K7.sample_fused.launches))
        assert got[0] == got[1] and got[0][1] == want
        ptrs = ptrs or buffers()
        assert buffers() == ptrs
        for g, e in lanes:
            gm, em = g.macro(k), e.macro(k)
            assert torch.equal(gm.traces, em.traces)
            assert torch.equal(g.sl, e.sl)
            if g.use_cloud:
                assert torch.equal(g.ll, e.ll)
    st = graph.macro_stats()
    assert st["macros"] == 2 and st["replays"] >= 3
    assert eager.macro_stats()["replays"] == 0
    if fault:
        assert graph.health_stats() == eager.health_stats()
        assert graph.cloud_lane._macro.traces.shape[0] == 5
    if sampled:
        cloud = graph.cloud_lane._macro
        assert set(cloud.graphs) == {False, True}
        assert 0 < cloud.sample_replays < cloud.replays
        assert graph.edge_lane._macro.sample_replays \
            == graph.edge_lane._macro.replays
        assert cloud.per_replay(K7.sample_fused, sample=True) == k
        assert cloud.per_replay(K7.sample_fused) == 0


def rel(out, ref):
    """max|out - ref| / max|ref| over the tensor."""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,s,d", [(4, 8, 1, 40, 256),
                                         (8, 8, 1, 48, 256),
                                         (1, 8, 1, 2048, 256),
                                         (2, 4, 2, 77, 32)])
def test_flash_attention_bwd_matches_autograd_of_plain(cuda, b, h, kvh, s,
                                                       d):
    """K3's LSE output and K8 on (B, H, S, D) views of (B, S, H, D)
    tensors against autograd of K3's plain version (2**-6 of each
    gradient's max: P and dS rounded to bf16, then the gradient); the
    output unchanged by the LSE; two K8 calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, s, n, d, device=cuda, generator=g).bfloat16()
               .transpose(1, 2) for n in (h, kvh, kvh))
    do = torch.randn(b, h, s, d, device=cuda, generator=g).bfloat16()
    out, lse = K3.flash_attention(q, k, v, return_lse=True)
    assert torch.equal(out, K3.flash_attention(q, k, v))
    assert (lse - K3.attention_lse_plain(q, k)).abs().max() <= 1e-4
    before = K3.flash_attention_bwd.launches
    got = K3.flash_attention_bwd(q, k, v, out, do, lse)
    again = K3.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert K3.flash_attention_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(K3.flash_attention_plain(qr, kr, vr),
                              (qr, kr, vr), do)
    for x, y in zip(got, ref):
        assert x.shape == y.shape and rel(x, y) <= 2 ** -6


@pytest.mark.gpu
def test_flash_attention_train_takes_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 40, n, 256, device=cuda, generator=g)
               .bfloat16().transpose(1, 2).requires_grad_(True)
               for n in (8, 1, 1))
    before = (K3.flash_attention.launches, K3.flash_attention_bwd.launches)
    K3.flash_attention_train(q, k, v).float().square().sum().backward()
    assert (K3.flash_attention.launches, K3.flash_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,s,d,window", [(1, 4, 1, 2048, 256, 512),
                                                (8, 4, 1, 640, 256, 512),
                                                (3, 4, 1, 40, 256, 512),
                                                (2, 4, 2, 77, 32, 16)])
def test_flash_attention_bwd_windowed_matches_autograd_of_plain(
        cuda, b, h, kvh, s, d, window):
    """K8's windowed mode (gemma3's local layers: H 4, KV 1, window 512)
    from K3's windowed LSE against autograd of K3's windowed plain
    version, 2**-6 of each gradient's max as in the causal mode; two
    calls give the same bits; the windowed launches are counted."""
    g = torch.Generator(device=cuda).manual_seed(s + window)
    q, k, v = (torch.randn(b, s, n, d, device=cuda, generator=g).bfloat16()
               .transpose(1, 2) for n in (h, kvh, kvh))
    do = torch.randn(b, h, s, d, device=cuda, generator=g).bfloat16()
    out, lse = K3.flash_attention(q, k, v, window=window, return_lse=True)
    assert torch.equal(out, K3.flash_attention(q, k, v, window=window))
    assert (lse - K3.attention_lse_plain(q, k, window=window)
            ).abs().max() <= 1e-4
    before = K3.flash_attention_bwd.windowed_launches
    got = K3.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    again = K3.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    torch.cuda.synchronize()
    assert K3.flash_attention_bwd.windowed_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(K3.flash_attention_plain(qr, kr, vr,
                                                       window=window),
                              (qr, kr, vr), do)
    for x, y in zip(got, ref):
        assert x.shape == y.shape and rel(x, y) <= 2 ** -6


@pytest.mark.gpu
def test_flash_attention_train_windowed_takes_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(2, 600, n, 256, device=cuda, generator=g)
               .bfloat16().transpose(1, 2).requires_grad_(True)
               for n in (4, 1, 1))
    before = (K3.flash_attention.windowed_launches,
              K3.flash_attention_bwd.windowed_launches)
    K3.flash_attention_train(q, k, v, window=512).float().square().sum(
    ).backward()
    assert (K3.flash_attention.windowed_launches,
            K3.flash_attention_bwd.windowed_launches) == \
        (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,e,groups", [(2048, 2048, 1, 1),
                                          (2048, 256, 1, 1),
                                          (2048, 32768, 1, 1),
                                          (16384, 2048, 1, 1),
                                          (2048, 32768, 4, 4),
                                          (16384, 2048, 4, 4)])
def test_moe_lora_delta_bwd_matches_autograd_of_plain(cuda, k, n, e,
                                                      groups):
    """K9 against autograd of K5's plain version at T = 160: dA and dB
    within 1e-5 of their max (f32 sums in another order), dx within 2**-7
    (it rounds to bf16); two calls give the same bits; the training
    wrapper launches K5 forward and K9 backward once each."""
    g = torch.Generator(device=cuda).manual_seed(k + n + e)
    t = 160
    x, a, b = lora_case(cuda, g, t, k, n, e=e)
    gates = torch.softmax(torch.randn(groups, e, device=cuda, generator=g),
                          -1)
    dy = torch.randn(t, n, device=cuda, generator=g)
    got = KL.moe_lora_delta_bwd(x, a, b, gates, dy, t // groups)
    again = KL.moe_lora_delta_bwd(x, a, b, gates, dy, t // groups)
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(got, again))
    xs, as_, bs = (z.detach().clone().requires_grad_(True) for z in (x, a, b))
    ref = torch.autograd.grad(KL.moe_lora_delta_plain(
        xs, as_, bs, gates, t // groups), (xs, as_, bs), dy)
    assert rel(got[0], ref[0]) <= 2 ** -7
    assert max(rel(got[1], ref[1]), rel(got[2], ref[2])) <= 1e-5
    before = (KL.moe_lora_delta.launches, KL.moe_lora_delta_bwd.launches)
    y = KL.moe_lora_delta_train(xs, as_, bs, gates, t // groups)
    torch.autograd.grad(y, (xs, as_, bs), dy)
    assert (KL.moe_lora_delta.launches, KL.moe_lora_delta_bwd.launches) \
        == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("t,k,n,e,r,groups", [(37, 136, 200, 3, 8, 1),
                                              (36, 72, 520, 3, 12, 3),
                                              (24, 2048, 256, 24, 16, 2),
                                              (160, 2048, 2048, 10, 16, 4),
                                              (5, 8, 4, 1, 4, 5)])
def test_moe_lora_delta_bwd_ragged_shapes(cuda, t, k, n, e, r, groups):
    """K9 where T is no multiple of a tile, E r leaves threads idle or
    spans two column groups (384), and m ends inside a chunk: within the
    limits above of autograd of K5's plain version; r % 4 != 0 raises."""
    g = torch.Generator(device=cuda).manual_seed(t + k + n + e + r)
    x, a, b = lora_case(cuda, g, t, k, n, e=e, r=r)
    gates = torch.softmax(torch.randn(groups, e, device=cuda, generator=g),
                          -1)
    dy = torch.randn(t, n, device=cuda, generator=g)
    got = KL.moe_lora_delta_bwd(x, a, b, gates, dy, t // groups)
    xs, as_, bs = (z.detach().clone().requires_grad_(True) for z in (x, a, b))
    ref = torch.autograd.grad(KL.moe_lora_delta_plain(
        xs, as_, bs, gates, t // groups), (xs, as_, bs), dy)
    assert rel(got[0], ref[0]) <= 2 ** -7
    assert max(rel(got[1], ref[1]), rel(got[2], ref[2])) <= 1e-5
    with pytest.raises(ValueError):
        KL.moe_lora_delta_bwd(x, a[:, :r - 2].contiguous(),
                              b[..., :r - 2].contiguous(), gates, dy,
                              t // groups)


@pytest.mark.gpu
def test_training_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(8, 64, device=cuda)                 # f32: not bf16
    a = torch.zeros(1, 4, 64, device=cuda)
    b = torch.zeros(1, 32, 4, device=cuda)
    with pytest.raises(TypeError):
        KL.moe_lora_delta_bwd(x, a, b, torch.ones(1, 1, device=cuda),
                              torch.zeros(8, 32, device=cuda), 8)
    q = torch.zeros(1, 2, 8, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # head_dim 48
        K3.flash_attention_bwd(q, q[:, :1], q[:, :1], q, q,
                               torch.zeros(1, 2, 8, device=cuda))


def ssd_case(dev, g, b, s, h, p, n, grp, dtype):
    """Inputs of one Mamba-2 prefill scan as the model hands them over:
    x (b, s, h, p), B and C (b, s, grp, n) column slices of a conv-like
    (b, s, h p + 2 grp n) output, dt a softplus (f32), a = -exp(.)."""
    conv = torch.nn.functional.silu(torch.randn(
        b, s, h * p + 2 * grp * n, device=dev, generator=g)).to(dtype)
    x = conv[..., :h * p].unflatten(-1, (h, p))
    bm = conv[..., h * p:h * p + grp * n].unflatten(-1, (grp, n))
    cm = conv[..., h * p + grp * n:].unflatten(-1, (grp, n))
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, device=dev, generator=g) - 1.0)
    a = -torch.exp(0.5 * torch.randn(h, device=dev, generator=g))
    return x, bm, cm, dt, a


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,grp,dtype", [
    (1, 1536, 112, 64, 64, 1, torch.bfloat16),   # zamba2-7b's prefill
    (1, 27, 112, 64, 64, 1, torch.bfloat16),     # a demo prompt
    (1, 1, 112, 64, 64, 1, torch.bfloat16),
    (2, 203, 5, 24, 8, 1, torch.bfloat16),       # ragged S, P < 32
    (3, 77, 4, 20, 8, 2, torch.float32),         # two groups, P % 8 != 0
    (2, 512, 16, 16, 8, 1, torch.float32),       # the reduced width
])
def test_ssd_scan_matches_plain(cuda, b, s, h, p, n, grp, dtype):
    """K11 against the reference's chunk loop (``ssd_scan_plain``) on
    strided x, B and C; two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    case = ssd_case(cuda, g, b, s, h, p, n, grp, dtype)
    assert s == 1 or not (case[0].is_contiguous()
                          or case[1].is_contiguous())
    before = K11.ssd_scan.launches
    y, hf = K11.ssd_scan(*case)
    y2, hf2 = K11.ssd_scan(*case)
    torch.cuda.synchronize()
    assert K11.ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    ry, rh = K11.ssd_scan_plain(*case)
    assert y.dtype == hf.dtype == torch.float32
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    assert row_rel_err(y, ry) <= 1e-4
    assert ((hf - rh).abs().max() / rh.abs().max()).item() <= 1e-5


def ssd_rel(got, ref):
    """max|got - ref| / max|ref| over the tensor (0 for an all-zero
    pair)."""
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    return err / scale if scale else err


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,grp,dtype", [
    (4, 40, 112, 64, 64, 1, torch.bfloat16),     # zamba2-7b's client step
    (1, 512, 112, 64, 64, 1, torch.bfloat16),    # two reference chunks
    (2, 203, 5, 24, 8, 1, torch.bfloat16),       # ragged S, P < 32
    (3, 77, 4, 40, 64, 2, torch.float32),        # two groups, P ragged > 32
    (2, 130, 6, 20, 8, 2, torch.float32),        # N 8, two groups
    (1, 1, 112, 64, 64, 1, torch.bfloat16),
])
def test_ssd_scan_bwd_matches_plain(cuda, b, s, h, p, n, grp, dtype):
    """K11 with its chunk states returns K11's y and h_final bit for bit
    and the states ``ssd_chunk_states_plain`` gives (1e-5 of their max);
    K12 from them against ``ssd_scan_bwd_plain`` (autograd through the
    reference's chunk loop) on strided x, B and C: d(dt) and da 1e-4 of
    their max (K12 runs the recurrence, the plain version the chunk
    form, as K11's y), dx, dB and dC 2**-7 in bf16 (one rounding) and
    1e-4 in f32; two calls give the same bits; without ``need_da`` no
    da."""
    g = torch.Generator(device=cuda).manual_seed(s + h + n)
    case = ssd_case(cuda, g, b, s, h, p, n, grp, dtype)
    dy = torch.randn(b, s, h, p, device=cuda, generator=g)
    y0, h0 = K11.ssd_scan(*case)
    y1, h1, hc = K11.ssd_scan(*case, chunk_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    assert hc.shape == (b, -(-s // 64), h, p, n)
    assert ssd_rel(hc, K11.ssd_chunk_states_plain(*case)) <= 1e-5
    before = K11.ssd_scan_bwd.launches
    got = K11.ssd_scan_bwd(*case, dy, hc)
    again = K11.ssd_scan_bwd(*case, dy, hc)
    torch.cuda.synchronize()
    assert K11.ssd_scan_bwd.launches == before + 2
    assert all(torch.equal(u, w) for u, w in zip(got, again))
    ref = K11.ssd_scan_bwd_plain(*case, dy)
    low = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    for u, w, tol in zip(got, ref, (low, low, low, 1e-4, 1e-4)):
        assert u.shape == w.shape and u.dtype == w.dtype
        assert ssd_rel(u, w) <= tol
    assert K11.ssd_scan_bwd(*case, dy, hc, need_da=False)[4] is None


@pytest.mark.gpu
def test_ssd_scan_train_takes_the_kernels(cuda):
    """Train mode on the card runs K11 with its chunk states forward and
    K12 backward, never the plain versions: one launch each; the
    gradients reach the columns of the conv output that x, B and C are
    views of, within the limits above of autograd through the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    h, p, n = 8, 16, 64
    conv = torch.randn(2, 96, h * p + 2 * n, device=cuda,
                       generator=g).bfloat16().requires_grad_(True)
    dt = torch.nn.functional.softplus(
        torch.randn(2, 96, h, device=cuda, generator=g) - 1.0)
    a = -torch.exp(0.5 * torch.randn(h, device=cuda, generator=g))
    dt, a = dt.requires_grad_(True), a.requires_grad_(True)

    def views(t):
        return (t[..., :h * p].unflatten(-1, (h, p)),
                t[..., h * p:h * p + n].unflatten(-1, (1, n)),
                t[..., h * p + n:].unflatten(-1, (1, n)))
    dy = torch.randn(2, 96, h, p, device=cuda, generator=g)
    before = (K11.ssd_scan.launches, K11.ssd_scan_bwd.launches)
    y = K11.ssd_scan_train(*views(conv), dt, a)
    got = torch.autograd.grad(y, (conv, dt, a), dy)
    assert (K11.ssd_scan.launches, K11.ssd_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = torch.autograd.grad(K11.ssd_scan_train_plain(*views(conv), dt, a),
                              (conv, dt, a), dy)
    assert (K11.ssd_scan.launches, K11.ssd_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for u, w, tol in zip(got, ref, (2 ** -7, 1e-4, 1e-4)):
        assert u.shape == w.shape and ssd_rel(u, w) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,s", [(4, 32, 32, 40), (1, 32, 32, 1536),
                                       (2, 4, 2, 203)])
def test_flash_attention_bwd_head_dim_112(cuda, b, h, kvh, s):
    """K3's LSE and K8 at zamba2's head_dim 112 on (B, H, S, D) views of
    (B, S, H, D) tensors: the LSE within 1e-4 of the plain log-sum-exp,
    K3's output unchanged by it, K8 within 2**-6 of each gradient's max
    of autograd through K3's plain version; with the shared block's
    window of 4,096 (longer than S) K3's LSE and K8 equal the causal
    mode bit for bit, and the windowed launches are counted."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    q, k, v = k3_inputs(cuda, g, b, h, kvh, s, 112, layout="bshd")
    do = torch.randn(b, s, h, 112, device=cuda,
                     generator=g).bfloat16().transpose(1, 2)
    out, lse = K3.flash_attention(q, k, v, return_lse=True)
    wout, wlse = K3.flash_attention(q, k, v, window=4096, return_lse=True)
    assert torch.equal(out, K3.flash_attention(q, k, v))
    assert torch.equal(out, wout) and torch.equal(lse, wlse)
    assert (lse - K3.attention_lse_plain(q, k)).abs().max() <= 1e-4
    before = K3.flash_attention_bwd.windowed_launches
    got = K3.flash_attention_bwd(q, k, v, out, do, lse)
    win = K3.flash_attention_bwd(q, k, v, out, do, lse, window=4096)
    torch.cuda.synchronize()
    assert K3.flash_attention_bwd.windowed_launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(got, win))
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(K3.flash_attention_plain(qr, kr, vr),
                              (qr, kr, vr), do)
    for x, y in zip(got, ref):
        assert x.shape == y.shape and rel(x, y) <= 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,s", [(1, 32, 32, 1536), (1, 32, 32, 27),
                                       (2, 4, 2, 203)])
def test_flash_attention_head_dim_112(cuda, b, h, kvh, s):
    """K3 at zamba2's head_dim 112 on (B, H, S, D) views of (B, S, H, D)
    tensors: within the limit of the plain version, and with the shared
    block's window of 4,096 (longer than S) equal to causal bit for bit;
    the output's padded columns never reach memory."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    q, k, v = k3_inputs(cuda, g, b, h, kvh, s, 112, layout="bshd")
    out = K3.flash_attention(q, k, v)
    win = K3.flash_attention(q, k, v, window=4096)
    torch.cuda.synchronize()
    assert out.shape == (b, h, s, 112)
    assert out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, win)
    assert row_rel_err(out, K3.flash_attention_plain(q, k, v)) <= 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", [(1, 1536), (1, 27), (4, 40), (2, 203)])
def test_flash_attention_head_dim_64(cuda, b, s):
    """K3 at granite-moe's head_dim 64 (H 24 over KV 8: a GQA group of
    3) on (B, H, S, D) views of (B, S, H, D) tensors: within 2**-6 per
    row of the plain version; two calls bit-equal; the LSE within 1e-4
    of the plain log-sum-exp, and the output unchanged by it."""
    g = torch.Generator(device=cuda).manual_seed(s + b)
    q, k, v = k3_inputs(cuda, g, b, 24, 8, s, 64, layout="bshd")
    out = K3.flash_attention(q, k, v)
    again, lse = K3.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert out.shape == (b, 24, s, 64)
    assert out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, again)
    assert row_rel_err(out, K3.flash_attention_plain(q, k, v)) <= 2 ** -6
    assert (lse - K3.attention_lse_plain(q, k)).abs().max() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", [(4, 40), (1, 1536), (2, 203)])
def test_flash_attention_bwd_head_dim_64(cuda, b, s):
    """K8 at head_dim 64 (H 24 over KV 8, the dK/dV pass's heads split
    into parts of the group of 3 at 4 x 40) within 2**-6 of each
    gradient's max of autograd through K3's plain version; two calls
    bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(s + 64)
    q, k, v = k3_inputs(cuda, g, b, 24, 8, s, 64, layout="bshd")
    do = torch.randn(b, s, 24, 64, device=cuda,
                     generator=g).bfloat16().transpose(1, 2)
    out, lse = K3.flash_attention(q, k, v, return_lse=True)
    got = K3.flash_attention_bwd(q, k, v, out, do, lse)
    again = K3.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(K3.flash_attention_plain(qr, kr, vr),
                              (qr, kr, vr), do)
    for x, y in zip(got, ref):
        assert x.shape == y.shape and rel(x, y) <= 2 ** -6
