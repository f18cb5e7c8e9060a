"""Multi-read signal alignment in the port: the canonical branch of
``signalalign_tpu.pipeline.runner.run_alignment_batch``.

Reads are prepared on the host (scaling, anchors, band geometry,
segment splits, ``prepare_problem``), bucketed by shape, and each bucket
runs through ``HopperAligner``: the Hopper kernels on a CUDA device, their
plain twins on the CPU. The JAX runner's small-bucket gate, lane packing,
XLA fallback and per-device stripe queues exist for TPU reasons and have
no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from signalalign_tpu.io.guide import GuideAlignment
from signalalign_tpu.io.output import (posterior_score,
                                       write_assignments_tsv,
                                       write_full_tsv, write_vc_tsv)
from signalalign_tpu.io.read import NanoporeReadData
from signalalign_tpu.io.reference import ProcessedReference
from signalalign_tpu.models.pore_model import PoreModel
from signalalign_tpu.ops.band_geometry import (band_widths, build_band,
                                               get_split_points,
                                               remap_anchors_to_events,
                                               split_segment_by_width)
from signalalign_tpu.ops.scaling import (adjust_events_for_drift,
                                         estimate_nanopore_params)
from signalalign_tpu.utils.alphabet import max_paths_per_kmer
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops.banded_fb_hopper import HopperAligner
from signalalign_tpu_torch.pipeline.signal_align import (AlignmentConfig,
                                                         ReadAlignment,
                                                         _bucket_d, _bucket_w)

# forward-stack bytes one aligner call may hold on the device; larger
# buckets run in several calls
STACK_BYTES = 8 << 30


def prepare_read(read: NanoporeReadData, guide: GuideAlignment,
                 reference: ProcessedReference, model: PoreModel,
                 config: AlignmentConfig, strand_template: bool = True):
    """Host-side prep of one read -> (target, params, events, ev_start,
    [((x1, y1), problem, W, Dpad, P)])."""
    k = model.kmer_length
    qstart, qend = guide.query_start, guide.query_end
    if read.rna:
        qstart, qend = (read.read_length - guide.query_end,
                        read.read_length - guide.query_start)
    if strand_template:
        target = reference.template_target(guide.contig, guide.window_start,
                                           guide.window_end, guide.forward)
    else:
        target = reference.complement_target(
            guide.contig, guide.window_start, guide.window_end, guide.forward)
    if read.rna:
        target = target[::-1]

    params = dataclasses.replace(read.params)
    if config.estimate_params:
        assign_read = read.assign_read or read.template_read
        assign_map = read.assign_event_map \
            if read.assign_event_map is not None else read.event_map
        params = estimate_nanopore_params(assign_read, assign_map,
                                          read.events, model, params)
    events = adjust_events_for_drift(read.events, params.drift)
    ev_start = int(read.event_map[qstart])
    ev_end = int(read.event_map[qend - 1])
    window_events = events[ev_start:ev_end]
    lX = len(target) - k + 1
    lY = ev_end - ev_start
    if lY <= 0 or lX <= 0:
        raise ValueError(f"{read.read_label}: empty alignment window")

    anchors_rb = guide.anchor_pairs(config.constraint_trim)
    if read.rna:
        Lw = guide.window_length
        anchors_rb = [(Lw - 1 - x - (k - 1), read.read_length - 1 - q)
                      for x, q in anchors_rb]
        anchors_rb = sorted((x, q) for x, q in anchors_rb if x >= 0)
    anchors = remap_anchors_to_events(anchors_rb, read.event_map, qstart)
    anchors = [(x, y) for x, y in anchors if 0 <= x < lX and 0 <= y < lY]

    splits = get_split_points(anchors, lX, lY, config.split_bigger_than,
                              True, True)
    tasks = []
    j = 0
    for (x1, y1, x2, y2) in splits:
        seg_anchors = []
        while j < len(anchors):
            ax, ay = anchors[j]
            if ax + ay >= x2 + y2:
                break
            seg_anchors.append((ax - x1, ay - y1))
            j += 1
        # width-capped sub-splitting: confine band bulges to small blocks
        for (sx1, sy1, sx2, sy2, sub_anchors) in split_segment_by_width(
                seg_anchors, x2 - x1, y2 - y1,
                config.diagonal_expansion, config.max_band_width,
                config.max_segment_diagonals):
            seg_chars = target[x1 + sx1:x1 + sx2 + k - 1]
            seg_events = window_events[y1 + sy1:y1 + sy2]
            slX = len(seg_chars) - k + 1
            slY = len(seg_events)
            if slX < 1 or slY < 1:
                continue
            xmyL, xmyR = build_band(sub_anchors, slX, slY,
                                    config.diagonal_expansion)
            W = _bucket_w(int(band_widths(xmyL, xmyR).max()))
            Dpad = _bucket_d(slX + slY)
            P = max_paths_per_kmer(seg_chars, k, config.ambig_map)
            problem = bfb.prepare_problem(
                seg_chars, seg_events, model, params, config.ambig_map,
                W=W, Dpad=Dpad, P=P, mode=config.emission_mode,
                anchor_pairs=sub_anchors,
                expansion=config.diagonal_expansion)
            tasks.append(((x1 + sx1, y1 + sy1), problem, W, Dpad, P))
    return target, params, events, ev_start, tasks


def _check_slice(config: AlignmentConfig, call_variants) -> None:
    if call_variants is not None:
        raise NotImplementedError(
            "call_variants (site-mode calling) comes with ROADMAP slice 2")
    if config.compute_expectations:
        raise NotImplementedError(
            "compute_expectations (EM training) comes with ROADMAP slice 3")
    if config.emission_mode != bfb.MODE_MEAN_ONLY:
        raise NotImplementedError(
            f"emission mode {config.emission_mode}: the port runs "
            "MODE_MEAN_ONLY; MODE_HDP comes with ROADMAP slice 2")


def _stack_chunks(idxs: List[int], W: int, Dpad: int) -> List[List[int]]:
    per = max(1, STACK_BYTES // ((Dpad + 1) * W * 4))
    return [idxs[i:i + per] for i in range(0, len(idxs), per)]


def run_alignment_batch(
    reads_and_guides: Sequence[Tuple[NanoporeReadData, GuideAlignment]],
    reference: ProcessedReference,
    model: PoreModel,
    config: Optional[AlignmentConfig] = None,
    *,
    device: torch.device,
    strand_template: bool = True,
    call_variants: Optional[str] = None,
    verbose: bool = False,
    stage_seconds: Optional[Dict[str, float]] = None,
) -> List[ReadAlignment]:
    """Align many reads: prep -> shape buckets -> one ``HopperAligner``
    per bucket on ``device`` -> per-read results (failed reads dropped).

    ``stage_seconds``, when given, receives the wall seconds of each stage:
    "prep" (host), "kernels" (upload, both sweeps, survivor fetch; ends in
    a device synchronisation), "decode" (survivors to pairs) and
    "assemble".
    """
    config = config or AlignmentConfig()
    _check_slice(config, call_variants)
    stages: Dict[str, float] = defaultdict(float)
    t_stage = time.perf_counter()

    def mark(stage: str):
        nonlocal t_stage
        now = time.perf_counter()
        stages[stage] += now - t_stage
        t_stage = now

    def prep_one(rg):
        read, guide = rg
        try:
            return prepare_read(read, guide, reference, model, config,
                                strand_template=strand_template), None
        except Exception as exc:  # per-read fault isolation
            # (reference: KEY:FAILED handling, signalAlignment.py:627-737)
            return None, f"{type(exc).__name__}: {exc}"

    # numpy-heavy and independent per read: threads overlap the parts of
    # numpy that release the interpreter lock; order is preserved
    if len(reads_and_guides) > 3:
        nw = min(8, max(2, (os.cpu_count() or 4) - 2))
        with ThreadPoolExecutor(max_workers=nw) as ex:
            prep_out = list(ex.map(prep_one, reads_and_guides))
    else:
        prep_out = [prep_one(rg) for rg in reads_and_guides]

    tasks = []      # (read index, x1, y1, problem, W, Dpad, P)
    prepped = []    # (read, guide, target, params, events, ev_start, [task ids])
    for ridx, ((read, guide), (out_, failure)) in enumerate(
            zip(reads_and_guides, prep_out)):
        if failure is not None:
            if verbose:
                print(f"[runner] FAILED {read.read_label}: {failure}",
                      file=sys.stderr)
            continue
        target, params, events, ev_start, segs = out_
        ids = []
        for (off, problem, W, Dpad, P) in segs:
            ids.append(len(tasks))
            tasks.append((ridx, off[0], off[1], problem, W, Dpad, P))
        prepped.append((read, guide, target, params, events, ev_start, ids))
    mark("prep")

    buckets: Dict[Tuple[int, int, int], List[int]] = defaultdict(list)
    for i, t in enumerate(tasks):
        buckets[(t[4], t[5], t[6])].append(i)
    for (W, Dpad, P) in buckets:
        if P != 1:
            raise NotImplementedError(
                f"P={P} bucket (degenerate reference positions): "
                "paths-in-lanes come with ROADMAP slice 2")

    seg_results: List[Optional[dict]] = [None] * len(tasks)
    for (W, Dpad, P), idxs in buckets.items():
        for chunk in _stack_chunks(idxs, W, Dpad):
            aligner = HopperAligner([tasks[i][3] for i in chunk], W, device)
            arrays = aligner.run(config.threshold)
            mark("kernels")
            for i, r in zip(chunk, aligner.decode(arrays)):
                seg_results[i] = r
            mark("decode")

    out: List[ReadAlignment] = []
    for read, guide, target, params, events, ev_start, ids in prepped:
        if strand_template:
            fwd_out, ref_shift = guide.output_frame(read.rna)
        else:
            fwd_out = guide.forward
            ref_shift = guide.window_end if guide.forward \
                else guide.window_start
        all_pairs = []
        total_lp = 0.0
        gap = 0.0
        for si in ids:
            _, x1, y1 = tasks[si][:3]
            r = seg_results[si]
            total_lp += r["total_f"]
            gap = max(gap, abs(r["total_f"] - r["total_b"]))
            for prob, x, y, kmer in r["pairs"]:
                all_pairs.append((prob, x + x1, y + y1, kmer))
        all_pairs.sort(key=lambda r: (r[1] + r[2], r[1]))
        out.append(ReadAlignment(
            read_label=read.read_label, contig=guide.contig,
            forward=fwd_out, strand_template=strand_template,
            aligned_pairs=all_pairs, score=posterior_score(all_pairs),
            target=target, event_offset=ev_start, ref_offset=ref_shift,
            params=params, events=events, total_log_prob=total_lp,
            rna=read.rna, max_total_gap=gap))
    mark("assemble")
    if stage_seconds is not None:
        stage_seconds.update(stages)
    return out


def write_outputs(results: Sequence[ReadAlignment], model: PoreModel,
                  output_dir: str, output_format: str = "full") -> List[str]:
    """Per-read TSVs as the JAX ``run_signal_align`` writes them:
    ``<label>.sm.forward|backward.tsv`` (full), ``<label>.sm.vc.tsv``
    (variantCaller), both, or ``<label>.sm.assignments.tsv``."""
    if output_format not in ("full", "variantCaller", "both", "assignments"):
        if output_format == "variants":
            raise NotImplementedError(
                "variants output (site-mode calling) comes with ROADMAP "
                "slice 2")
        raise ValueError(f"unknown output format {output_format!r}")
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for r in results:
        # files are named by the ORIGINAL mapping strand (the RNA frame
        # flip is internal), signalAlignment.py:330-346
        fwd_orig = (not r.forward) if r.rna else r.forward
        fwd_label = "forward" if fwd_orig else "backward"
        if output_format in ("full", "both"):
            path = os.path.join(output_dir,
                                f"{r.read_label}.sm.{fwd_label}.tsv")
            write_full_tsv(path, r.full_rows(model), append=False)
            written.append(path)
        if output_format in ("variantCaller", "both"):
            path = os.path.join(output_dir, f"{r.read_label}.sm.vc.tsv")
            write_vc_tsv(path, r.vc_rows(model), append=False)
            written.append(path)
        if output_format == "assignments":
            path = os.path.join(output_dir,
                                f"{r.read_label}.sm.assignments.tsv")
            write_assignments_tsv(path, r.aligned_pairs, r.events, model,
                                  r.params, r.strand_template,
                                  r.event_offset, append=False)
            written.append(path)
    return written
