"""Anchor-constrained band geometry for the anti-diagonal DP: the port's
copy of ``signalalign_tpu.ops.band_geometry``.

The DP matrix is (lX+1) x (lY+1) cells over x (reference k-mers, 1-based) and
y (events, 1-based); anti-diagonal coordinates are xay = x+y and xmy = x-y.
Cells on one anti-diagonal share xay; the band restricts each diagonal to
[xmyL, xmyR] with xmy stepping by 2.

This reproduces the geometry of the reference band iterator
(band_construct / band_setCurrentDiagonal, the reference's
impl/pairwiseAligner.c:155-246): anchors (x, y) become waypoints (x+1, y+1) in
matrix coordinates; between consecutive waypoints the band is the
intersection of each diagonal with a rectangle whose corners are the two
waypoints expanded by ``expansion`` along the xmy axis.

All of this is cheap integer work done host-side in NumPy; the output arrays
(per-diagonal band origin and width) parameterize the fixed-width device
kernels.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _x_of(xay: int, xmy: int) -> int:
    return (xay + xmy) // 2


def _y_of(xay: int, xmy: int) -> int:
    return (xay - xmy) // 2


def _fix_parity(xay: int, xmy: int) -> int:
    return xmy if (xay + xmy) % 2 == 0 else xmy + 1


def _bound(z: int, hi: int) -> int:
    return 0 if z < 0 else (hi if z > hi else z)


def _diagonal_for(xay: int, xL: int, yL: int, xU: int, yU: int) -> Tuple[int, int]:
    """Intersect anti-diagonal ``xay`` with the rectangle [xL..xU] x [yU..yL].

    Returns (xmyL, xmyR). Mirrors band_setCurrentDiagonal
    (pairwiseAligner.c:170-194) including the off-by-one parity avoidance and
    the sequential clamping order.
    """
    xmyL = _fix_parity(xay, xL - yL)
    xmyR = _fix_parity(xay, xU - yU)

    # clamp left edge: push right until x >= xL, then until y <= yL
    if _x_of(xay, xmyL) < xL:
        xmyL += 2 * (xL - _x_of(xay, xmyL))
    if yL < _y_of(xay, xmyL):
        xmyL += 2 * (_y_of(xay, xmyL) - yL)
    # clamp right edge: pull left until x <= xU, then until y >= yU
    if xU < _x_of(xay, xmyR):
        xmyR -= 2 * (_x_of(xay, xmyR) - xU)
    if _y_of(xay, xmyR) < yU:
        xmyR -= 2 * (yU - _y_of(xay, xmyR))
    return xmyL, xmyR


def build_band(anchor_pairs: Sequence[Tuple[int, int]], lX: int, lY: int,
               expansion: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-diagonal band [xmyL[d], xmyR[d]] for d = 0..lX+lY.

    ``anchor_pairs`` are (x, y) in *sequence* coordinates (0-based), strictly
    increasing in both coordinates (pre-filtered). ``expansion`` must be even.
    """
    if expansion % 2 != 0:
        raise ValueError("expansion must be even")
    n_diag = lX + lY + 1
    xmyL = np.zeros(n_diag, dtype=np.int64)
    xmyR = np.zeros(n_diag, dtype=np.int64)

    anchor_idx = 0
    xay = 0
    pxay = pxmy = 0
    nxay = nxmy = 0
    xL = yL = xU = yU = 0
    while xay <= lX + lY:
        xmyL[xay], xmyR[xay] = _diagonal_for(xay, xL, yL, xU, yU)
        if nxay == xay:
            xay += 1
            pxay, pxmy = nxay, nxmy
            x, y = lX, lY
            if anchor_idx < len(anchor_pairs):
                ax, ay = anchor_pairs[anchor_idx]
                anchor_idx += 1
                x, y = ax + 1, ay + 1  # matrix coordinates are sequence + 1
                if not (x > _x_of(pxay, pxmy) and y > _y_of(pxay, pxmy)
                        and 0 < x <= lX and 0 < y <= lY):
                    raise ValueError(
                        f"anchor ({ax},{ay}) out of order or out of range for "
                        f"lX={lX} lY={lY}")
            nxay, nxmy = x + y, x - y
            xL = _bound(_x_of(pxay, pxmy - expansion), lX)
            yL = _bound(_y_of(nxay, nxmy - expansion), lY)
            xU = _bound(_x_of(nxay, nxmy + expansion), lX)
            yU = _bound(_y_of(pxay, pxmy + expansion), lY)
        else:
            xay += 1
    return xmyL, xmyR


def band_widths(xmyL: np.ndarray, xmyR: np.ndarray) -> np.ndarray:
    return (xmyR - xmyL) // 2 + 1


def filter_to_remove_overlap(pairs: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Longest chain of pairs strictly increasing in both coordinates.

    Mirrors filterToRemoveOverlap (pairwiseAligner.c:1755-1795): keep a pair
    iff it is strictly below-left of everything after it and strictly
    above-right of everything before it. Input must be sorted by (x, y).
    """
    pairs = list(pairs)
    keep = set()
    px = py = np.iinfo(np.int64).max
    for i in range(len(pairs) - 1, -1, -1):
        x, y = pairs[i]
        if x < px and y < py:
            keep.add((x, y))
        px, py = min(x, px), min(y, py)
    out: List[Tuple[int, int]] = []
    px = py = np.iinfo(np.int64).min
    for x, y in pairs:
        if x > px and y > py and (x, y) in keep:
            out.append((x, y))
        px, py = max(x, px), max(y, py)
    return out


def get_split_points(anchor_pairs: Sequence[Tuple[int, int]], lX: int, lY: int,
                     split_bigger_than: int,
                     ragged_left: bool, ragged_right: bool) -> List[Tuple[int, int, int, int]]:
    """Split the DP matrix at large anchor gaps into (x1, y1, x2, y2) blocks.

    Mirrors getSplitPoints (pairwiseAligner.c:1886-1951): an inter-anchor gap
    whose sub-matrix exceeds ``split_bigger_than`` cells is cut, leaving
    sqrt(split)-sized ragged flanks around each anchor run.
    """
    split_points: List[Tuple[int, int, int, int]] = []
    x1 = y1 = 0
    x2 = y2 = 0

    def consider(x3: int, y3: int, skip_block: bool) -> bool:
        nonlocal x1, y1
        lx2, ly2 = x3 - x2, y3 - y2
        if lx2 * ly2 > split_bigger_than:
            max_len = int(np.sqrt(split_bigger_than))
            hX = min(lx2 // 2, max_len)
            hY = min(ly2 // 2, max_len)
            if not skip_block:
                split_points.append((x1, y1, x2 + hX, y2 + hY))
            x1, y1 = x3 - hX, y3 - hY
            return True
        return False

    for i, (ax, ay) in enumerate(anchor_pairs):
        consider(ax, ay, ragged_left and i == 0)
        x2, y2 = ax + 1, ay + 1
    ended_split = consider(lX, lY, ragged_left and len(anchor_pairs) == 0)
    if not ended_split or not ragged_right:
        split_points.append((x1, y1, lX, lY))
    return split_points


# width-class ladder: mirrors signal_align._bucket_w — sub-segments are
# split so each one's max band width lands in the smallest class that
# covers it (the kernels' per-diagonal cost is the padded class width)
_W_CLASSES = (64, 128, 256, 512, 768, 1024)


def _width_class_cuts(anchors, w, lX, lY,
                      min_run: int) -> List[Tuple[int, int]]:
    """Cut points confining a bimodal width profile: when a long run of
    diagonals is at least one width CLASS narrower than the segment max,
    cut at the anchors just inside that run so the narrow bulk buckets
    into a cheaper kernel shape. Returns [] when no split pays."""
    wmax = int(w.max())
    cls = next((c for c in _W_CLASSES if wmax <= c), None)
    if cls is None or cls == _W_CLASSES[0] or not anchors:
        return []
    thr = _W_CLASSES[_W_CLASSES.index(cls) - 1]
    narrow = w <= thr
    if narrow.all() or not narrow.any():
        return []
    # longest maximal narrow run
    edges = np.flatnonzero(np.diff(narrow.astype(np.int8)))
    starts = np.concatenate([[0], edges + 1])
    ends = np.concatenate([edges, [len(narrow) - 1]])
    runs = [(int(s), int(e)) for s, e in zip(starts, ends) if narrow[s]]
    s, e = max(runs, key=lambda r: r[1] - r[0])
    if e - s + 1 < min_run:
        return []
    # anchors just inside the run's edges (diag of anchor = ax+ay+2)
    inside = [a for a in anchors if s <= a[0] + a[1] + 2 <= e]
    if not inside:
        return []
    cuts = []
    if s > 0:                       # run starts mid-segment: cut before it
        a = inside[0]
        cuts.append((a[0] + 1, a[1] + 1))
    if e < len(narrow) - 1:         # run ends mid-segment: cut after it
        a = inside[-1]
        if not cuts or (a[0] + 1, a[1] + 1) != cuts[0]:
            cuts.append((a[0] + 1, a[1] + 1))
    return cuts


def split_segment_by_width(
        anchor_pairs: Sequence[Tuple[int, int]], lX: int, lY: int,
        expansion: int, cap: int, max_diag: int = 0,
        min_class_run: int = 1500,
        _depth: int = 0) -> List[Tuple[int, int, int, int, List[Tuple[int, int]]]]:
    """Split a segment whose band exceeds ``cap`` cells in width — at the
    anchors flanking the bulge — or whose diagonal count exceeds
    ``max_diag`` (0 = no limit) — at the anchor nearest the midpoint —
    or whose width profile is bimodal (a run of >= ``min_class_run``
    diagonals at least one width class narrower than the segment max:
    the narrow bulk then buckets into a cheaper kernel shape instead of
    paying the bulge's padded width on every diagonal; measured band
    widths on the bundled reads are median ~100 with maxima 300-900, so
    this is worth ~1.5-2x of sweep+compaction cost).
    Returns (x1, y1, x2, y2, rel_anchors) blocks covering
    [0,0]..[lX,lY] in order.

    TPU-native banding policy (no reference counterpart). A localized band
    bulge — a large inter-anchor gap — would otherwise bucket the WHOLE
    read into a wide-band device shape that exceeds the lane-batched
    kernel's VMEM budget; cutting at the bulge's flanking anchors confines
    the wide band to a small block (which falls back to the per-read
    kernel) while the bulk keeps the fast fixed-width shape. The diagonal
    cap bounds the per-lane DP-stack HBM of very long reads and makes
    device shape buckets homogeneous. All cuts pin the path at an anchor,
    exactly like the reference's own getSplitPoints cuts
    (pairwiseAligner.c:1886-1951).
    """
    anchors = list(anchor_pairs)
    whole = [(0, 0, lX, lY, anchors)]
    if lX <= 0 or lY <= 0 or _depth > 16:
        return whole
    cuts: List[Tuple[int, int]] = []
    if max_diag and lX + lY > max_diag and anchors:
        # cut at the anchor nearest the diagonal midpoint
        mid = (lX + lY) // 2
        best = min(anchors, key=lambda a: abs(a[0] + a[1] + 2 - mid))
        cuts = [(best[0] + 1, best[1] + 1)]
    else:
        xmyL, xmyR = build_band(anchors, lX, lY, expansion)
        w = band_widths(xmyL, xmyR)
        if int(w.max()) <= cap:
            if min_class_run:
                cuts = _width_class_cuts(anchors, w, lX, lY,
                                         min_class_run)
            if not cuts:
                return whole
        else:
            wide = np.nonzero(w > cap)[0]
            dlo, dhi = int(wide.min()), int(wide.max())
            # anchor (ax, ay) sits on matrix diagonal ax + ay + 2
            before = [a for a in anchors if a[0] + a[1] + 2 <= dlo]
            after = [a for a in anchors if a[0] + a[1] + 2 >= dhi]
            cut_anchors = []
            if before:
                cut_anchors.append(before[-1])
            if after and (not before or after[0] != before[-1]):
                cut_anchors.append(after[0])
            cuts = [(ax + 1, ay + 1) for ax, ay in cut_anchors]
    cuts = [(cx, cy) for cx, cy in cuts if 0 < cx < lX and 0 < cy < lY]
    cuts = sorted(set(cuts), key=lambda c: (c[0] + c[1], c[0]))
    if not cuts:
        return whole
    out: List[Tuple[int, int, int, int, List[Tuple[int, int]]]] = []
    px = py = 0
    j = 0
    for (cx, cy) in cuts + [(lX, lY)]:
        sub: List[Tuple[int, int]] = []
        while j < len(anchors):
            ax, ay = anchors[j]
            if ax + ay >= cx + cy:
                break
            sub.append((ax - px, ay - py))
            j += 1
        for (rx1, ry1, rx2, ry2, ra) in split_segment_by_width(
                sub, cx - px, cy - py, expansion, cap, max_diag,
                min_class_run, _depth + 1):
            out.append((px + rx1, py + ry1, px + rx2, py + ry2, ra))
        px, py = cx, cy
    return out


def split_segment_by_paths(
        anchor_pairs: Sequence[Tuple[int, int]], lX: int, lY: int,
        hot_mask: np.ndarray, merge_gap: int = 64,
) -> List[Tuple[int, int, int, int, List[Tuple[int, int]]]]:
    """Cut runs of high-path-expansion positions (``hot_mask`` True at
    kmer starts whose degenerate expansion exceeds the cheap class) into
    their own blocks.

    TPU-native policy (no reference counterpart): paths-in-lanes costs
    PP lanes per read segment, padded to the SEGMENT max — on the
    bundled CpG workloads only ~4% of positions carry adjacent-CpG
    (P=4) windows, yet they forced 4 path-lanes on whole segments.
    Isolating each hot cluster at its flanking anchors lets the ~96%
    bulk run at PP=2 (double the reads per stripe); clusters closer
    than ``merge_gap`` merge to bound fragmentation. Cuts pin the path
    at an anchor like every other split.
    """
    anchors = list(anchor_pairs)
    whole = [(0, 0, lX, lY, anchors)]
    hot = np.nonzero(np.asarray(hot_mask))[0]
    if hot.size == 0 or not anchors or lX <= 0 or lY <= 0:
        return whole
    clusters = []
    c0 = prev = int(hot[0])
    for h in hot[1:]:
        if int(h) - prev > merge_gap:
            clusters.append((c0, prev))
            c0 = int(h)
        prev = int(h)
    clusters.append((c0, prev))
    cuts: List[Tuple[int, int]] = []
    for (h0, h1) in clusters:
        before = [a for a in anchors if a[0] + 1 <= h0]
        after = [a for a in anchors if a[0] >= h1 + 1]
        if before:
            cuts.append((before[-1][0] + 1, before[-1][1] + 1))
        if after:
            cuts.append((after[0][0] + 1, after[0][1] + 1))
    cuts = [(cx, cy) for cx, cy in cuts if 0 < cx < lX and 0 < cy < lY]
    cuts = sorted(set(cuts), key=lambda c: (c[0] + c[1], c[0]))
    # drop non-monotone cut sequences (clusters sharing flank anchors)
    mono: List[Tuple[int, int]] = []
    for c in cuts:
        if not mono or (c[0] > mono[-1][0] and c[1] >= mono[-1][1]):
            mono.append(c)
    if not mono:
        return whole
    out: List[Tuple[int, int, int, int, List[Tuple[int, int]]]] = []
    px = py = 0
    j = 0
    for (cx, cy) in mono + [(lX, lY)]:
        if cx <= px or cy < py:
            continue
        sub: List[Tuple[int, int]] = []
        while j < len(anchors):
            ax, ay = anchors[j]
            if ax + ay >= cx + cy:
                break
            sub.append((ax - px, ay - py))
            j += 1
        out.append((px, py, cx - px, cy - py, sub))
        px, py = cx, cy
    # convert (x1, y1, w, h, anchors) -> (x1, y1, x2, y2, anchors)
    return [(x1, y1, x1 + w, y1 + h, a) for (x1, y1, w, h, a) in out]


def remap_anchors_to_events(anchor_pairs: Sequence[Tuple[int, int]],
                            event_map: np.ndarray, map_offset: int) -> List[Tuple[int, int]]:
    """Map (ref_pos, read_pos) anchors to (ref_pos, event_index) anchors via
    the per-base event map, rebasing events to the trimmed window.

    reference: nanopore_remapAnchorPairsWithOffset (nanopore.c:535-547)
    followed by overlap filtering (signalMachineUtils.c:166-171).
    """
    base = int(event_map[map_offset])
    remapped = [(x, int(event_map[y]) - base) for x, y in anchor_pairs]
    return filter_to_remove_overlap(remapped)
