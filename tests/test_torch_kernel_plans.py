"""The plans of the port's two latency- and bandwidth-bound kernels, on the
CPU, and numpy/torch emulations of what the kernels do with them.

- soft-NMS (``csrc/soft_nms.cu``): the planner's shards, and the sharded
  two-level argmax over order-preserving keys with slots double-buffered
  by the pick's parity (a block pushing the next pick's winner before the
  others have read this one's), against ``greedy_picks``;
- the fused depthwise's fast path (``csrc/fused_dw.cu``): the 16-byte
  staged window and band against every read of the stencil, and the staged
  window plus the column-segment stencil against
  ``fused_depthwise_plain`` with TF SAME borders;
- the fused separable conv (``csrc/fused_sepconv.cu``): the band planner's
  plans (d0's pinned; Cin > 128 to the resident kernel, whose walk of
  groups over bands covers each band and slice once), and the staged bands
  of global rows with their depthwise pairs, product and scatter back to
  the images against ``fused_sepconv_plain``.

The kernels themselves are held against the plain versions on a card in
``tests/test_torch_cuda.py``.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fixtures import one_cpu_thread  # noqa: E402,F401
from tests.test_torch_cuda import random_batch, score_threshold  # noqa: E402
from udal_tpu_torch.ops import cuda_nms, fused_dw, fused_sepconv, nms  # noqa: E402

# -- soft-NMS ------------------------------------------------------------------

NO_INDEX = np.uint32(0xFFFFFFFF)
SOURCES = Path(cuda_nms.__file__).resolve().parent.parent / "csrc"


def test_nms_shards_cover_every_candidate_once():
    """For N from 1 to 8192: CLUSTER contiguous shards in rank order, each
    candidate in exactly one, one candidate a thread, whole warps, at most
    MAX_THREADS, and no warp without a candidate."""
    for n in range(1, cuda_nms.MAX_CANDIDATES + 1):
        plan = cuda_nms.plan(n)
        spans = cuda_nms.shards(n)
        assert len(spans) == cuda_nms.CLUSTER and spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(0 <= hi - lo <= plan.shard <= plan.threads for lo, hi in spans)
        assert plan.threads % 32 == 0 and plan.threads <= cuda_nms.MAX_THREADS
        assert plan.threads - 32 < plan.shard


def test_nms_planner_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="at most"):
        cuda_nms.plan(cuda_nms.MAX_CANDIDATES + 1)
    with pytest.raises(ValueError, match="at most"):
        cuda_nms.plan(0)


def test_nms_planner_models_the_sources_launch():
    """The planner's cluster size and threads a block are the source's."""
    src = (SOURCES / "soft_nms.cu").read_text()
    assert f"constexpr int kCluster = {cuda_nms.CLUSTER};" in src
    assert f"constexpr int kMaxThreads = {cuda_nms.MAX_THREADS};" in src
    assert "(n + kCluster - 1) / kCluster" in src and "(shard + 31) / 32 * 32" in src


def order_key(scores):
    """The kernel's order_key: an unsigned key in the order of the f32
    scores, -0 as +0."""
    u = np.ascontiguousarray(scores, np.float32).view(np.uint32).copy()
    u[scores == 0] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def key_score(key):
    u = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key).astype(np.uint32)
    return u.view(np.float32)


def best(keys, idx, axis):
    """(largest key, smallest index at it) along ``axis``: redux.sync's max
    then min, as warp_best."""
    top = keys.max(axis=axis)
    return top, np.where(keys == np.expand_dims(top, axis), idx, NO_INDEX).min(axis=axis)


def block_winner(work, lo, threads):
    """A block's winner over its shard's working scores ``work``
    (candidates lo, lo + 1, ...): thread t holds lo + t, each warp its
    best, then warp 0 the best of the warps. Empty threads hold the key 0."""
    keys = np.zeros(threads, np.uint32)
    idx = np.full(threads, NO_INDEX, np.uint32)
    keys[:len(work)] = order_key(work)
    idx[:len(work)] = np.arange(lo, lo + len(work), dtype=np.uint32)
    k, i = best(keys.reshape(-1, 32), idx.reshape(-1, 32), 1)
    return best(k, i, 0)


def decay(work, box, lane, pick, bb, iou_threshold, score_threshold, sigma):
    """One shard's decay against the pick's box bb, in greedy_picks'
    expressions and order."""
    y1, x1, y2, x2 = box.unbind(-1)
    area = torch.clamp_min(y2 - y1, 0.0) * torch.clamp_min(x2 - x1, 0.0)
    barea = torch.clamp_min(bb[2] - bb[0], 0.0) * torch.clamp_min(bb[3] - bb[1], 0.0)
    inter = (torch.clamp_min(torch.minimum(y2, bb[2]) - torch.maximum(y1, bb[0]), 0.0)
             * torch.clamp_min(torch.minimum(x2, bb[3]) - torch.maximum(x1, bb[1]), 0.0))
    union = area + barea - inter
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)
    if sigma > 0:
        weight = torch.where(iou <= iou_threshold, torch.exp(-(iou * iou) / sigma), 0.0)
    else:
        weight = (iou <= iou_threshold).to(torch.float32)
    decayed = work * weight
    dead = (weight == 0.0) | (decayed < score_threshold) | (lane == pick)
    return torch.where(dead, nms.NEG_INF, decayed)


def sharded_picks(boxes, scores, k, iou_threshold, score_threshold, sigma):
    """The kernel's picks, emulated with its double-buffered slots and the
    race they guard: at each pick, the blocks read the slots of the pick's
    parity in rank order, and each block, as soon as it has read them and
    decayed its shard, pushes its winner of the next pick into every
    block's slot of the other parity, before the blocks after it have read
    this pick's. Every block must reach the same pick."""
    b, n = scores.shape
    threads = cuda_nms.plan(n).threads
    spans = cuda_nms.shards(n)
    sel_idx = np.zeros((b, k), np.int64)
    sel_scores = np.zeros((b, k), np.float32)
    for img in range(b):
        box = torch.from_numpy(boxes[img])
        works = [torch.from_numpy(scores[img, lo:hi].copy()) for lo, hi in spans]
        slots = np.zeros((2, cuda_nms.CLUSTER, 2), np.uint32)   # (key, index) by parity
        for r, (lo, _) in enumerate(spans):
            slots[0, r] = block_winner(works[r].numpy(), lo, threads)
        for i in range(k):
            par = i & 1
            seen = set()
            for r, (lo, hi) in enumerate(spans):
                top, pick = best(slots[par, :, 0], slots[par, :, 1], 0)
                seen.add((int(top), int(pick)))
                works[r] = decay(works[r], box[lo:hi], torch.arange(lo, hi), int(pick),
                                 box[int(pick)], iou_threshold, score_threshold, sigma)
                slots[1 - par, r] = block_winner(works[r].numpy(), lo, threads)
            assert len(seen) == 1, f"pick {i}: the blocks read {seen}"
            top, pick = seen.pop()
            sel_idx[img, i], sel_scores[img, i] = pick, key_score(np.uint32(top))
    return sel_idx, sel_scores


@pytest.mark.parametrize("n", [1, 7, 37, 300, 1025, 8192])
@pytest.mark.parametrize("sigma,tied", [(0.5, False), (0.0, False), (0.5, True), (0.0, True)])
def test_sharded_argmax_emulation_equals_greedy_picks(sigma, tied, n):
    """Random and tied scores (three values: ties in every shard and across
    them), gaussian and hard, from one candidate (seven empty shards) to
    the largest N: the emulated kernel's picks equal greedy_picks', and so
    do its scores."""
    boxes, scores = random_batch(40 + n, n, b=2, tied=tied)
    thr = score_threshold(sigma)
    got_idx, got_scores = sharded_picks(boxes, scores, 12, 0.5, thr, sigma)
    want_idx, want_scores = nms.greedy_picks(torch.from_numpy(boxes), torch.from_numpy(scores),
                                             12, 0.5, thr, sigma)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_scores, want_scores.numpy())


def test_sharded_argmax_emulation_breaks_ties_at_shard_edges():
    """Equal top scores at the last candidate of shard 0, the first of the
    last shard and inside shard 1, an equal runner-up pair across shards,
    on boxes that do not overlap: the lowest index first, as greedy_picks."""
    n = 5000
    boxes, scores = random_batch(31, n, b=1)
    scores = scores * 0.5
    spans = cuda_nms.shards(n)
    top = [spans[0][1] - 1, spans[-1][0], spans[1][0] + 5]
    runner = [spans[-1][1] - 1, spans[1][0]]
    for i, j in enumerate(top + runner):
        boxes[:, j] = [1000.0 * (i + 1), 0.0, 1000.0 * (i + 1) + 10.0, 10.0]
    scores[:, top] = 0.9
    scores[:, runner] = 0.8
    got_idx, _ = sharded_picks(boxes, scores, 8, 0.5, 0.001, 0.5)
    want_idx, _ = nms.greedy_picks(torch.from_numpy(boxes), torch.from_numpy(scores),
                                   8, 0.5, 0.001, 0.5)
    assert got_idx[0, :5].tolist() == sorted(top) + sorted(runner)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())


def test_order_key_keeps_the_order_of_scores():
    """Keys order as the floats do (-0 equal to +0), above the empty key
    0, and decode to the score."""
    s = np.asarray([-np.inf, -1e10, -1.5, -1e-30, -0.0, 0.0, 1e-30, 0.001, 0.5, 1.0, np.inf],
                   np.float32)
    k = order_key(s)
    assert (k > 0).all()
    assert all(a <= b for a, b in zip(k, k[1:])) and k[4] == k[5]
    assert (np.diff(k.astype(np.int64))[[i for i in range(len(s) - 1) if i != 4]] > 0).all()
    np.testing.assert_array_equal(key_score(k), np.where(s == 0, 0.0, s).astype(np.float32))


# -- the fused depthwise's fast path ------------------------------------------

WIDTHS = {2: (8, 16, 40, 64, 128, 512), 4: (4, 12, 40, 64, 72, 512)}


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_row_window_covers_every_read_and_is_aligned(k, s, itemsize):
    """The staged window starts on a 16-byte group at or left of TF SAME's
    leading pad, holds whole groups, no more than one group past the
    stencil's last read, and maps every (output column, tap) to the image
    column it reads; a band's staged rows hold every row its segments
    read."""
    v = 16 // itemsize
    for w in WIDTHS[itemsize]:
        gwa, off, iwx = fused_dw.row_window(w, k, s, itemsize)
        pad_l = fused_dw.same_pads(w, k, s)[0]
        wo = -(-w // s)
        assert gwa % v == 0 and iwx % v == 0 and gwa <= -pad_l and off == -pad_l - gwa
        q = np.arange(wo)[:, None]
        dx = np.arange(k)[None, :]
        staged = off + q * s + dx
        assert staged.min() >= 0 and staged.max() < iwx and staged.max() >= iwx - v
        np.testing.assert_array_equal(gwa + staged, q * s - pad_l + dx)
    for th in fused_dw.ROW_BANDS:
        rows = (th - 1) * s + k
        r0 = np.arange(0, th, fused_dw.ROW_SEG)[:, None]
        reads = r0 * s + np.arange((fused_dw.ROW_SEG - 1) * s + k)[None, :]
        assert reads.min() == 0 and reads.max() == rows - 1


def test_row_plan_takes_whole_groups_and_fits_its_ring():
    """Rows of whole 16-byte groups only; bands a multiple of the segment,
    within the ring's budget; the MC prefix in bands of 16 rows; f32 rows
    too wide for a band of 8 go to the general path."""
    assert fused_dw.row_plan(19, 70, 3, 1, 4) is None
    assert fused_dw.row_plan(9, 20, 3, 1, 2) is None
    assert fused_dw.row_plan(9, 2048, 5, 2, 4) is None
    assert fused_dw.row_plan(256, 512, 3, 1, 2) == fused_dw.RowPlan(16, -8, 7, 528)
    for h, w, k, s, itemsize in ((64, 64, 3, 1, 4), (33, 40, 5, 2, 2), (256, 512, 5, 2, 2),
                                 (16, 32, 5, 1, 4), (3, 8, 3, 1, 2)):
        plan = fused_dw.row_plan(h, w, k, s, itemsize)
        assert plan.th % fused_dw.ROW_SEG == 0
        assert (fused_dw.row_smem_bytes(plan.th, plan.iwx, k, s, itemsize)
                <= fused_dw.ROW_SMEM_BUDGET)


def swish(v):
    return v / (np.float32(1) + np.exp(-v))


def emulate_rows(x, taps, scale, bias, mask, k, s, itemsize):
    """The fast path in numpy, f32: each band's rows staged 16-byte group by
    group (a group outside the image zero-filled), then every item of
    ROW_SEG rows by two columns formed from the staged values, its rows
    past the image not stored; the mean from the stored values."""
    n, c, h, w = x.shape
    plan = fused_dw.row_plan(h, w, k, s, itemsize)
    v = 16 // itemsize
    ho, wo = fused_dw.output_size(h, w, s)
    pad_t = fused_dw.same_pads(h, k, s)[0]
    rows = (plan.th - 1) * s + k
    y = np.zeros((n, c, ho, wo), np.float32)
    total = np.zeros((n, c), np.float32)
    seg = fused_dw.ROW_SEG
    for band in range(-(-ho // plan.th)):
        stage = np.zeros((n, c, rows, plan.iwx), np.float32)
        gh0 = band * plan.th * s - pad_t
        for r in range(rows):
            for g in range(plan.iwx // v):
                gh, gw = gh0 + r, plan.gwa + g * v
                if 0 <= gh < h and 0 <= gw < w:
                    stage[:, :, r, g * v:(g + 1) * v] = x[:, :, gh, gw:gw + v]
        for r0 in range(0, plan.th, seg):
            for half in (0, 1):
                q = np.arange(half, wo, 2)
                for o in range(seg):
                    oh = band * plan.th + r0 + o
                    if oh >= ho:
                        continue
                    acc = np.zeros((n, c, len(q)), np.float32)
                    for dy in range(k):
                        for dx in range(k):
                            col = plan.off + q * s + dx
                            acc += stage[:, :, (r0 + o) * s + dy, col] * taps[None, :, dy, dx,
                                                                              None]
                    val = swish(acc * scale[None, :, None] + bias[None, :, None])
                    val = val * mask[:, :, None]
                    y[:, :, oh, q] = val
                    total += val.sum(-1)
    return y, total / np.float32(ho * wo)


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("h,w,itemsize", [(19, 40, 2), (12, 64, 4)])
def test_row_emulation_equals_the_plain_version(k, s, h, w, itemsize):
    """Staged window plus column stencil equals fused_depthwise_plain (TF
    SAME borders, ragged last band), f32 within 1e-5, mean within 1e-6."""
    rng = np.random.RandomState(k * 10 + s + w)
    n, c = 2, 3
    x = rng.normal(0, 1, (n, c, h, w)).astype(np.float32)
    taps = rng.normal(0, 1.0 / k, (c, k, k)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mask = ((rng.uniform(size=(n, c)) < 0.8) / 0.8).astype(np.float32)
    got_y, got_mean = emulate_rows(x, taps, scale, bias, mask, k, s, itemsize)
    want_y, want_mean = fused_dw.fused_depthwise_plain(
        *(torch.from_numpy(a) for a in (x, taps, scale, bias, mask)), s, "swish", True)
    np.testing.assert_allclose(got_y, want_y.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_mean, want_mean.numpy(), atol=1e-6, rtol=1e-5)


# -- the fused separable conv ---------------------------------------------------

# (n, cin, h, w): d0's levels at 1024x512 at the BiFPN's and the heads'
# batches, d7x's at 1536x768, and edges (odd, one-pixel and wide rows)
SEP_SHAPES = ([(n, 64, h, w) for n in (8, 80, 320)
               for h, w in ((64, 128), (32, 64), (16, 32), (8, 16), (4, 8))]
              + [(n, 384, h, w) for n in (8, 80)
                 for h, w in ((96, 192), (48, 96), (24, 48), (12, 24), (6, 12), (3, 6))]
              + [(3, 40, 5, 7), (2, 24, 1, 1), (2, 24, 2, 300), (1, 8, 9, 130)])


@pytest.mark.parametrize("cout", [63, 64, 72, 90, 100, 200, 384])
def test_sepconv_plans_cover_the_tensor_and_fit(cout):
    """Every plan: whole rows or bands of a multiple of 8 columns, a band's
    pairs within the block's pixels. Cin <= 128: a ``Plan`` of the
    narrowest configuration whose block covers Cout (slices of the widest
    beyond) within the shared-memory budget. Cin > 128: a ``ResidentPlan``
    of the fewest slices of at most 192 outputs (multiples of 48) that
    cover Cout, a cluster pair exactly where there are two, within the 227
    KB a block may have, and a grid of whole groups no larger than the
    card's SMs or the bands' groups."""
    for n, cin, h, w in SEP_SHAPES:
        p = fused_sepconv.plan(n, cin, cout, h, w)
        assert 1 <= p.th <= n * h
        assert p.tw == w or (p.tw % 8 == 0 and p.tw < w)
        if cin > fused_sepconv.RESIDENT_FROM:
            assert isinstance(p, fused_sepconv.ResidentPlan)
            assert p.th * fused_sepconv.pair_width(p.tw) <= fused_sepconv.R_PIXELS
            assert p.mb % 48 == 0 and 48 <= p.mb <= 192
            assert p.slices == -(-cout // 192) and (p.slices - 1) * p.mb < cout <= p.slices * p.mb
            assert p.pair == (p.slices == 2)
            assert (fused_sepconv.resident_smem_bytes(cin, p.mb, p.pair, p.th, p.tw)
                    <= 227 * 1024)
            bands = -(-(n * h) // p.th) * -(-w // p.tw)
            assert p.grid % p.slices == 0
            assert p.grid // p.slices == min(bands, fused_sepconv.sm_count() // p.slices)
            continue
        assert isinstance(p, fused_sepconv.Plan)
        mb, nb = fused_sepconv.TC_CONFIGS[p.cfg]
        narrower = fused_sepconv.TC_CONFIGS[:p.cfg]
        assert cout <= mb or p.cfg == len(fused_sepconv.TC_CONFIGS) - 1
        assert all(cout > m for m, _ in narrower)
        assert (p.slices - 1) * mb < cout <= p.slices * mb
        assert p.th * fused_sepconv.pair_width(p.tw) <= nb
        assert fused_sepconv.smem_bytes(p.cfg, cin, p.th, p.tw) <= fused_sepconv.SMEM_BUDGET


# d0's plans at 1024x512, level by level (P3..P7), as the first kernel's
# planner made them before the resident kernel came: (cfg, th, tw, slices)
D0_PLANS = {64: [(0, 2, 128, 1), (0, 4, 64, 1), (0, 8, 32, 1), (0, 16, 16, 1), (0, 25, 8, 1)],
            72: [(1, 1, 128, 1), (1, 2, 64, 1), (1, 4, 32, 1), (1, 8, 16, 1), (1, 16, 8, 1)]}


@pytest.mark.parametrize("n", [8, 32, 80, 320])
@pytest.mark.parametrize("cout", [63, 64, 72, 90])
def test_sepconv_d0_plans_stay_as_they_were(n, cout):
    """Every d0 launch (Cin = 64: the BiFPN nodes at B = 8 / 32 / 80, the
    towers at T·B = 80 / 320, the predict convs at Cout 63 / 72 / 90) keeps
    the first kernel and its plan."""
    levels = [(64, 128), (32, 64), (16, 32), (8, 16), (4, 8)]
    want = D0_PLANS[64 if cout <= 64 else 72]
    got = [fused_sepconv.plan(n, 64, cout, h, w) for h, w in levels]
    assert all(type(p) is fused_sepconv.Plan for p in got)
    assert [tuple(p) for p in got] == want


# (n, cin, cout, h, w): d7x's levels for the towers, nodes and predicts,
# d4's width at odd levels, a ragged second slice, and Cout beyond a pair
RESIDENT_SHAPES = ([(n, 384, cout, h, w) for n, cout in ((80, 384), (8, 384), (80, 90), (80, 72))
                    for h, w in ((96, 192), (48, 96), (24, 48), (12, 24), (6, 12), (3, 6))]
                   + [(3, 224, 100, h, w) for h, w in ((5, 7), (9, 21), (1, 1), (2, 300))]
                   + [(2, 384, 200, 7, 12), (2, 384, 200, 3, 520), (4, 160, 810, 10, 40)])


def resident_walk(p, bands):
    """The source's walk: block b keeps slice b % slices, and its group
    b // slices takes bands group, group + groups, … (groups = grid //
    slices). Returns each block's (band, slice) in order."""
    groups = p.grid // p.slices
    return [[(band, b % p.slices) for band in range(b // p.slices, bands, groups)]
            for b in range(p.grid)]


@pytest.mark.parametrize("shape", RESIDENT_SHAPES)
def test_resident_walk_covers_each_band_and_slice_once(shape):
    """At the plan's grid, at a grid of one group, and at grids larger than
    the bands' groups (blocks with no band) or of many times fewer groups:
    every (band, slice) once, each block one slice of W from first band to
    last, and the blocks of a group (a cluster for a pair) on the same
    bands in the same order."""
    n, cin, cout, h, w = shape
    p = fused_sepconv.plan(n, cin, cout, h, w)
    bands = -(-(n * h) // p.th) * -(-w // p.tw)
    for groups in {p.grid // p.slices, 1, bands + 3, max(1, bands // 7)}:
        q = p._replace(grid=groups * p.slices)
        walk = resident_walk(q, bands)
        done = sorted(item for block in walk for item in block)
        assert done == [(b, s) for b in range(bands) for s in range(p.slices)]
        for b, block in enumerate(walk):
            assert {s for _, s in block} <= {b % p.slices}
            mates = walk[b - b % p.slices:b - b % p.slices + p.slices]
            assert all([band for band, _ in m] == [band for band, _ in block] for m in mates)
        assert sum(not block for block in walk) == p.slices * max(0, groups - bands)


@pytest.mark.parametrize("pair", [True, False])
def test_resident_copies_fit_the_producers_slots(pair):
    """Every band the resident kernel stages with 16-byte copies (its
    columns a multiple of 8, at most 64 pixels) needs at most 4 copies a
    producer thread a chunk (256 threads), the kernel's slots
    (``resident_copies`` in the source: channels x staged rows x 16-byte
    groups); the launch refuses more."""
    ch = 16 if pair else 32
    for tw in range(8, fused_sepconv.R_PIXELS + 1, 8):
        for th in range(1, fused_sepconv.R_PIXELS // tw + 1):
            assert (th + 2) * (fused_sepconv.staged_width(tw) // 8) * ch <= 4 * 256, (th, tw)


def test_resident_plans_fit_the_card_and_split_d7x_in_a_pair():
    """d7x's towers and nodes (384 -> 384) take a cluster pair of 192-wide
    slices, its predict convs one slice of 96, bands of at most 64 pixels
    (2 rows by 32 columns at P3 and P4, the kernel's 2 x 2 depthwise); a
    grid of at most one block an SM (132 without a card)."""
    for n, cin, cout, h, w in RESIDENT_SHAPES[:24]:
        p = fused_sepconv.plan(n, cin, cout, h, w)
        assert (p.mb, p.slices) == ((192, 2) if cout == 384 else (96, 1))
        assert p.grid <= fused_sepconv.sm_count()
        assert p.th * fused_sepconv.pair_width(p.tw) <= 64
        if h in (96, 48):
            assert p[:2] == (2, 32)


def emulate_sepconv(x, taps, w, scale, bias, mask, p):
    """The kernel's arithmetic on its plan ``p``: each band's TH + 2 global
    rows staged from column c0 - LEFT (zeros outside the tensor), the
    depthwise of each pair from the 6 staged values of columns c - 2 to
    c + 3 of each row, a row whose neighbour lies in another image or
    outside it taking no tap from it, the 1x1 product, then each pixel of
    the band back to its image, row and column. f32, pre and post the
    identity."""
    n, cin, h, wd = x.shape
    th, tw = p.th, p.tw
    twp, sw = fused_sepconv.pair_width(tw), fused_sepconv.staged_width(tw)
    left = fused_sepconv.LEFT
    rows = n * h
    xg = x.permute(1, 0, 2, 3).reshape(cin, rows, wd)
    t = taps.reshape(cin, 3, 3)
    y = torch.full((n, w.shape[0], h, wd), float("nan"))
    for g0 in range(0, rows, th):
        for c0 in range(0, wd, tw):
            staged = torch.zeros(cin, th + 2, sw)
            lo, hi = max(0, c0 - left), min(wd, c0 - left + sw)
            for rr in range(th + 2):
                if 0 <= g0 - 1 + rr < rows:
                    staged[:, rr, lo - c0 + left:hi - c0 + left] = xg[:, g0 - 1 + rr, lo:hi]
            d = torch.zeros(cin, th * twp)
            for q in range(0, th * twp, 2):
                r, c = divmod(q, twp)
                yy = (g0 + r) % h
                for ky in range(3):
                    if (ky == 0 and yy == 0) or (ky == 2 and yy == h - 1):
                        continue
                    v = staged[:, r + ky, left - 2 + c:left + 4 + c]
                    d[:, q] += (t[:, ky] * v[:, 1:4]).sum(1)
                    d[:, q + 1] += (t[:, ky] * v[:, 2:5]).sum(1)
            z = w.reshape(w.shape[0], cin) @ d * scale[:, None] + bias[:, None]
            for q in range(th * twp):
                r, c = divmod(q, twp)
                if g0 + r >= rows or c >= tw or c0 + c >= wd:
                    continue
                img, yy = divmod(g0 + r, h)
                y[img, :, yy, c0 + c] = z[:, q] * (1.0 if mask is None else mask[img])
    assert not torch.isnan(y).any(), "a pixel no band wrote"
    return y


@pytest.mark.parametrize("n,cin,cout,h,w", [
    (3, 8, 64, 5, 7), (2, 8, 100, 3, 20), (2, 16, 200, 2, 300), (3, 8, 72, 4, 9), (2, 8, 64, 1, 1),
    (2, 136, 100, 3, 20), (3, 136, 200, 5, 7)])
def test_sepconv_emulation_equals_the_plain_version(n, cin, cout, h, w):
    """On the plan of a shape (bands spanning images, two column bands, an
    odd width, single pixels; the resident kernel's bands at Cin > 128),
    the emulated kernel's values are the plain version's (f32, up to the
    order of the sums)."""
    g = torch.Generator().manual_seed(n * w + cout)
    x = torch.randn((n, cin, h, w), generator=g)
    taps = torch.randn((cin, 1, 3, 3), generator=g) / 3
    wt = torch.randn((cout, cin, 1, 1), generator=g) / cin ** 0.5
    scale, bias = torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g)
    mask = ((torch.rand((n, cout), generator=g) < 0.9) / 0.9).float()
    p = fused_sepconv.plan(n, cin, cout, h, w)
    want = fused_sepconv.fused_sepconv_plain(x, taps, wt, scale, bias, mask)
    torch.testing.assert_close(emulate_sepconv(x, taps, wt, scale, bias, mask, p), want,
                               atol=1e-5, rtol=1e-5)
