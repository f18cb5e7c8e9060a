"""Maximum-expected-accuracy decoding of posterior aligned pairs.

reference: maximum_expected_accuracy_alignment
(src/signalalign/mea_algorithm.py:25-200 fast version, 615-726 slow
specification). Semantics: process (event, ref, posterior) pairs in event
order; a path may move to a strictly larger reference position (adding the
pair's posterior to the running sum) or stay at the same reference position
(sum unchanged); the result is the path whose posterior sum is maximal.

The port's copy of ``signalalign_tpu.pipeline.mea``: a Pareto-frontier
DP — the frontier holds edges with strictly increasing (ref, sum); the
best predecessor for a new pair is the frontier entry with the largest
ref < r (binary search). O(n log n).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass
class MeaNode:
    ref: int
    event: int
    prob: float
    total: float
    prev: Optional["MeaNode"]


def mea_align(pairs: Sequence[Tuple[int, int, float]]) -> List[Tuple[int, int, float]]:
    """pairs: (ref_index, event_index, posterior). Returns the MEA path as
    [(ref, event, prob), ...] in event order."""
    if not len(pairs):
        return []
    order = sorted(range(len(pairs)), key=lambda i: (pairs[i][1], pairs[i][0]))

    # frontier: parallel lists of refs (strictly increasing) and nodes whose
    # totals are strictly increasing with ref
    f_refs: List[int] = []
    f_nodes: List[MeaNode] = []

    def frontier_insert(node: MeaNode):
        i = bisect.bisect_left(f_refs, node.ref)
        if i < len(f_refs) and f_refs[i] == node.ref:
            if f_nodes[i].total >= node.total:
                return
            f_refs.pop(i)
            f_nodes.pop(i)
        elif i > 0 and f_nodes[i - 1].total >= node.total:
            return  # dominated
        f_refs.insert(i, node.ref)
        f_nodes.insert(i, node)
        # drop newly dominated successors
        j = i + 1
        while j < len(f_nodes) and f_nodes[j].total <= node.total:
            f_refs.pop(j)
            f_nodes.pop(j)

    cur_event = pairs[order[0]][1]
    staged: List[MeaNode] = []
    best: Optional[MeaNode] = None

    for idx in order:
        r, e, p = pairs[idx]
        if e != cur_event:
            for n in staged:
                frontier_insert(n)
            staged = []
            cur_event = e
        # best predecessor with ref < r
        i = bisect.bisect_left(f_refs, r)
        pred = f_nodes[i - 1] if i > 0 else None
        total_move = p + (pred.total if pred else 0.0)
        # stay option: an existing edge at exactly ref r keeps its total
        stay = None
        if i < len(f_refs) and f_refs[i] == r:
            stay = f_nodes[i]
        if stay is not None and stay.total > total_move:
            node = MeaNode(r, e, p, stay.total, stay.prev)
        else:
            node = MeaNode(r, e, p, total_move, pred)
        staged.append(node)
        if best is None or node.total > best.total:
            best = node

    for n in staged:
        frontier_insert(n)

    path = []
    n = best
    while n is not None:
        path.append((n.ref, n.event, n.prob))
        n = n.prev
    path.reverse()
    return path


def mea_slow_spec(pairs: Sequence[Tuple[int, int, float]]) -> float:
    """O(n^2) specification of the MEA objective (for tests): returns the
    maximal path posterior sum."""
    order = sorted(range(len(pairs)), key=lambda i: (pairs[i][1], pairs[i][0]))
    nodes = [pairs[i] for i in order]
    best_total = [0.0] * len(nodes)
    result = 0.0
    for i, (r, e, p) in enumerate(nodes):
        t = p
        for j in range(i):
            rj, ej, _ = nodes[j]
            if ej < e and rj < r:
                t = max(t, p + best_total[j])
            elif ej < e and rj == r:
                t = max(t, best_total[j])
        best_total[i] = t
        result = max(result, t)
    return result
