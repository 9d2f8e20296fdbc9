"""How far served packed tuples lie from the reference's.

Detections are matched image by image: the served ones in score order,
each to the unmatched reference detection of the same class with the
highest IoU, at least ``MATCH_IOU``. Per image:

- ``unmatched``: the share of the image's score mass, on either side, in
  detections the other side has no match for (which boxes and classes the
  T-moments, the top-k and the soft-NMS chose);
- ``sigma_gap``: the median, over the served detections, of each one's
  gap in uncertainty: for a matched one, the median relative difference of
  its σ_al, σ_mc and σ_cls (the decode and the T samples' spread, so the
  masks each sample was served with), each against the larger of the
  reference's value and a tenth of its mean over the pairs, at most 1; an
  unmatched one counts 1;
- ``score_gap``: the median, over the matched pairs, of the relative gap
  of the served score against the reference's (the class decode and the
  soft-NMS decay), against the larger of the reference's score and a
  tenth of its mean over the pairs, at most 1;
- ``box_gap``: the median, over the matched pairs, of the largest of the
  four corners' offsets, each over the reference box's height or width
  (the anchor decode and the scale back to the frame), at most 1.

The two gaps are 1 for an image with detections on either side and no
pair, and 0 for one with none on both. Random weights on noise frames
leave near-ties among the candidates, so a bf16 serve picks some other
detections than an f32 reference on an image; the check takes the mean
of each number over all compared images, which a fault that spoils every
image, or half of them, moves far and rounding does not.

The check compares four numbers (``COMPARED``): ``unmatched`` and
``sigma_gap`` as they are, and the score and box gaps as ratios to the
same gaps of a witness, the reference in bfloat16 against the f32 one
(``score_vs_bf16``, ``box_vs_bf16``). How far rounding moves the scores
and boxes differs from one seed's random network to another's by up to
eight times, for the program and the witness alike, and the ratio takes
that out; a rounding step below bf16, a scaled score or a shifted box
still reads several times the witness.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

MATCH_IOU = 0.5
NAMES = ("unmatched", "sigma_gap", "score_gap", "box_gap")
COMPARED = ("unmatched", "sigma_gap", "score_vs_bf16", "box_vs_bf16")


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, M] IoU of y1x1y2x2 boxes."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lo = torch.maximum(a[:, None, :2], b[None, :, :2])
    hi = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (hi - lo).clamp_min(0).prod(-1)
    union = area_a[:, None] + area_b[None] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12), 0.0)


def _relative(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|x - y| against the larger of |y| and a tenth of its mean, at most 1."""
    floor = 0.1 * y.abs().mean()
    gap = torch.where(x == y, 0.0, (x - y).abs() / torch.maximum(y.abs(), floor))
    return torch.nan_to_num(gap, nan=1.0).clamp(max=1.0)


def _finite(x: float) -> float:
    """x, or inf where it is not a number (a fault, never a pass)."""
    return x if x == x and abs(x) != float("inf") else float("inf")


def image_numbers(p: Sequence[torch.Tensor], r: Sequence[torch.Tensor], i: int
                  ) -> Dict[str, float]:
    """The numbers of image ``i`` of two packed tuples (host tensors)."""
    n_p, n_r = int(p[3][i]), int(r[3][i])

    def unpack(t, n):
        return dict(box=t[0][i, :n, :4].double(), al=t[0][i, :n, 4:8].double(),
                    mc=t[0][i, :n, 8:12].double(), score=t[1][i, :n].double(),
                    cls=t[2][i, :n, 0], scls=t[2][i, :n, 1:].double())

    a, b = unpack(p, n_p), unpack(r, n_r)
    iou = _iou(a["box"], b["box"]) if n_p and n_r else torch.zeros((n_p, n_r))
    iou = torch.where(a["cls"][:, None] == b["cls"][None], iou, -1.0)
    free = torch.ones(n_r, dtype=torch.bool)
    pairs = []
    for j in range(n_p if n_r else 0):
        cand = torch.where(free, iou[j], -1.0)
        best = int(cand.argmax())
        if float(cand[best]) >= MATCH_IOU:
            free[best] = False
            pairs.append((j, best))

    mp = torch.zeros(n_p, dtype=torch.bool)
    mr = torch.zeros(n_r, dtype=torch.bool)
    gaps = torch.ones(n_p, dtype=torch.float64)
    pair_gaps = dict(score_gap=float(n_p > 0 or n_r > 0), box_gap=float(n_p > 0 or n_r > 0))
    if pairs:
        jp = torch.tensor([j for j, _ in pairs])
        jr = torch.tensor([q for _, q in pairs])
        mp[jp] = mr[jr] = True
        rel = [_relative(a[key][jp], b[key][jr]) for key in ("al", "mc", "scls")]
        gaps[jp] = torch.cat(rel, 1).median(1).values
        pair_gaps["score_gap"] = float(_relative(a["score"][jp], b["score"][jr]).median())
        pb, rb = a["box"][jp], b["box"][jr]
        size = (rb[:, 2:] - rb[:, :2]).clamp_min(1e-6).repeat(1, 2)
        offset = torch.nan_to_num((pb - rb).abs() / size, nan=1.0).amax(1).clamp(max=1.0)
        pair_gaps["box_gap"] = float(offset.median())

    def share(side, matched):
        total = float(side["score"].sum())
        return float(side["score"][~matched].sum()) / total if total > 0 else 0.0

    out = dict(unmatched=max(share(a, mp), share(b, mr)),
               sigma_gap=float(gaps.median()) if n_p else float(n_r > 0), **pair_gaps)
    return {key: _finite(v) for key, v in out.items()}


def batch_numbers(p: Sequence[torch.Tensor], r: Sequence[torch.Tensor]) -> List[Dict[str, float]]:
    """Each image's numbers of one batch."""
    return [image_numbers(p, r, i) for i in range(p[1].shape[0])]


def aggregate(images: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The mean of each number over the compared images."""
    return {n: sum(x[n] for x in images) / len(images) for n in NAMES}


def numbers(p: Sequence[torch.Tensor], r: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The numbers of one batch."""
    return aggregate(batch_numbers(p, r))


def compared(served: Dict[str, float], witness: Dict[str, float]) -> Dict[str, float]:
    """The check's numbers from the served tuples' aggregate numbers and the
    witness's, both against the f32 reference."""
    ratio = lambda n: _finite(served[n] / witness[n]) if witness[n] > 0 else float("inf")
    return dict(unmatched=served["unmatched"], sigma_gap=served["sigma_gap"],
                score_vs_bf16=ratio("score_gap"), box_vs_bf16=ratio("box_gap"))
