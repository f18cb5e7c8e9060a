"""Multi-read signal alignment in the port: ``run_signal_align`` (the CLI's
``run``: fast5, SAM/BAM, readdb and positions files in, TSVs out; fast5s
with event tables or raw signal only, and ``--embed``),
``run_signal_align_2d`` (``run --2d``: both strands of 2D fast5s) and the
Gaussian (MODE_MEAN_ONLY) and HDP (MODE_HDP) branches of
``signalalign_tpu.pipeline.runner.run_alignment_batch`` for segments of
any number of paths per cell, with pair output, site-mode
variant/methylation calling, or the EM expectation pass.

Reads are prepared on the host (scaling, anchors, band geometry,
segment and path-class splits, ``prepare_problem``), bucketed by shape,
and each bucket runs through ``HopperAligner``: the Hopper kernels on a
CUDA device, their plain twins on the CPU. In HDP mode the HDP's tables
are converted to float32 once, shared by every problem, and uploaded to
the device once per call. The opt-in probability-space branch
(``SIGNALALIGN_TPU_PROB_KERNELS=1``) runs where the JAX runner runs its
probability-space kernels, with its residual guard and exact re-run. The
JAX runner's small-bucket gate otherwise, lane packing, XLA fallback and
per-device stripe queues exist for TPU reasons and have no counterpart
here.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from signalalign_tpu_torch.io.fast5 import Fast5, import_h5py
from signalalign_tpu_torch.io.embed import embed_alignment
from signalalign_tpu_torch.io.guide import (GuideAlignment,
                                            adjust_reference_coordinate,
                                            guide_from_sam_record)
from signalalign_tpu_torch.io.output import (posterior_score,
                                             write_assignments_tsv,
                                             write_full_tsv, write_vc_tsv)
from signalalign_tpu_torch.io.minialign import generate_guide_alignment
from signalalign_tpu_torch.io.read import NanoporeRead2DData, NanoporeReadData
from signalalign_tpu_torch.convert import hdp_tables
from signalalign_tpu_torch.io.reference import ProcessedReference
from signalalign_tpu_torch.io.sam import filter_reads
from signalalign_tpu_torch.models.hdp_model import NanoporeHDP
from signalalign_tpu_torch.models.pore_model import PoreModel
from signalalign_tpu_torch.ops import banded_fb as bfb
from signalalign_tpu_torch.ops.band_geometry import (band_widths, build_band,
                                                     get_split_points,
                                                     remap_anchors_to_events,
                                                     split_segment_by_paths,
                                                     split_segment_by_width)
from signalalign_tpu_torch.ops.banded_fb_hopper import HopperAligner
from signalalign_tpu_torch.ops.scaling import (adjust_events_for_drift,
                                               estimate_nanopore_params)
from signalalign_tpu_torch.pipeline.event_align import nanopore_read_from_raw
from signalalign_tpu_torch.pipeline.signal_align import (AlignmentConfig,
                                                         ReadAlignment,
                                                         _bucket_d, _bucket_w)
from signalalign_tpu_torch.pipeline.variant_caller import (
    aggregate_over_reads, marginals_from_site_probs, per_read_calls_dataframe,
    variant_calls_dataframe)
from signalalign_tpu_torch.utils.alphabet import (max_paths_per_kmer,
                                                  paths_per_kmer)
from signalalign_tpu_torch.utils.native import NativeLibraryError

# forward-stack bytes one aligner call may hold on the device; larger
# buckets run in several calls. An expectation bucket whose backward keeps
# its three-state stack too (banded_fb_hopper.expect_split) holds a
# backward stack of the same size beside it
STACK_BYTES = 8 << 30
# the JAX runner's switch for its probability-space kernels (read where
# it reads it), and the smallest bucket it sends to them: smaller ones
# take its per-read-row kernels (runner.py:417-448)
PROB_SWITCH = "SIGNALALIGN_TPU_PROB_KERNELS"
PROB_MIN_BUCKET = 32


def _path_blocks(w_chars: str, k: int, anchors, lX: int, lY: int,
                 config: AlignmentConfig):
    """Path-class sub-splitting of one width block (the JAX runner's
    tiered isolation): cut sparse P>2 windows into their own blocks when
    the blocks stay long, else sparse P>4 windows."""
    blocks = [(0, 0, lX, lY, anchors)]
    if not config.path_split or \
            max_paths_per_kmer(w_chars, k, config.ambig_map) <= 2:
        return blocks
    ppk = paths_per_kmer(w_chars, k, config.ambig_map)
    for thresh in (2, 4):
        hotv = ppk > thresh
        if not hotv.any() or hotv.mean() > 0.25:
            continue
        cand = split_segment_by_paths(anchors, lX, lY, hotv)
        if thresh == 2 and lX / max(len(cand), 1) < 400:
            continue    # too fragmented; isolate only P>4
        return cand
    return blocks


def read_window(read: NanoporeReadData, guide: GuideAlignment,
                reference: ProcessedReference, model: PoreModel,
                config: AlignmentConfig, strand_template: bool = True):
    """The host steps every entry point takes before it splits a read:
    the target, scaling, drift-adjusted events, the guide's event window
    and its anchors -> (target, params, events, ev_start, window_events,
    anchors, splits), ``splits`` the ``get_split_points`` segments (x1,
    y1, x2, y2) (the JAX ``align_read``, ``signal_align.py:134-189``)."""
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
    return target, params, events, ev_start, window_events, anchors, splits


def split_anchors(anchors, splits):
    """Each ``get_split_points`` segment with its anchors, shifted to the
    segment's origin: [((x1, y1, x2, y2), anchors)]."""
    out, j = [], 0
    for (x1, y1, x2, y2) in splits:
        seg = []
        while j < len(anchors) and sum(anchors[j]) < x2 + y2:
            seg.append((anchors[j][0] - x1, anchors[j][1] - y1))
            j += 1
        out.append(((x1, y1, x2, y2), seg))
    return out


def segment_shape(seg_chars: str, n_events: int, anchors, k: int,
                  config: AlignmentConfig) -> Tuple[int, int, int]:
    """(W, Dpad, P) of one segment: its band's width and diagonal count
    bucketed, and its paths per cell."""
    slX = len(seg_chars) - k + 1
    xmyL, xmyR = build_band(anchors, slX, n_events, config.diagonal_expansion)
    W = _bucket_w(int(band_widths(xmyL, xmyR).max()))
    P = max_paths_per_kmer(seg_chars, k, config.ambig_map)
    return W, _bucket_d(slX + n_events), P


def prepare_read(read: NanoporeReadData, guide: GuideAlignment,
                 reference: ProcessedReference, model: PoreModel,
                 config: AlignmentConfig, hdp: Optional[NanoporeHDP] = None,
                 strand_template: bool = True):
    """Host-side prep of one read -> (target, params, events, ev_start,
    [((x1, y1), problem, W, Dpad, P)])."""
    k = model.kmer_length
    target, params, events, ev_start, window_events, anchors, splits = \
        read_window(read, guide, reference, model, config, strand_template)
    tasks = []
    for (x1, y1, x2, y2), seg_anchors in split_anchors(anchors, splits):
        # width-capped sub-splitting: confine band bulges to small blocks
        for (sx1, sy1, sx2, sy2, sub_anchors) in split_segment_by_width(
                seg_anchors, x2 - x1, y2 - y1,
                config.diagonal_expansion, config.max_band_width,
                config.max_segment_diagonals):
            w_chars = target[x1 + sx1:x1 + sx2 + k - 1]
            for (px1, py1, px2, py2, p_anchors) in _path_blocks(
                    w_chars, k, sub_anchors, sx2 - sx1, sy2 - sy1, config):
                ax1, ay1 = sx1 + px1, sy1 + py1
                ax2, ay2 = sx1 + px2, sy1 + py2
                seg_chars = target[x1 + ax1:x1 + ax2 + k - 1]
                seg_events = window_events[y1 + ay1:y1 + ay2]
                slX = len(seg_chars) - k + 1
                slY = len(seg_events)
                if slX < 1 or slY < 1:
                    continue
                W, Dpad, P = segment_shape(seg_chars, slY, p_anchors, k,
                                           config)
                problem = bfb.prepare_problem(
                    seg_chars, seg_events, model, params, config.ambig_map,
                    W=W, Dpad=Dpad, P=P, mode=config.emission_mode,
                    anchor_pairs=p_anchors,
                    expansion=config.diagonal_expansion, hdp=hdp)
                tasks.append(((x1 + ax1, y1 + ay1), problem, W, Dpad, P))
    return target, params, events, ev_start, tasks


def _check_slice(config: AlignmentConfig, hdp) -> None:
    if config.emission_mode not in (bfb.MODE_MEAN_ONLY, bfb.MODE_HDP):
        raise NotImplementedError(
            f"emission mode {config.emission_mode}: the port runs "
            "MODE_MEAN_ONLY and MODE_HDP (ROADMAP §3 item 4)")
    if config.emission_mode == bfb.MODE_HDP and hdp is None:
        raise ValueError("MODE_HDP requires an hdp model (hdp=)")


def _stack_chunks(idxs: List[int], W: int, Dpad: int, P: int,
                  states: int = 1) -> List[List[int]]:
    """Chunks of a bucket whose forward stacks (``states`` rows per
    diagonal: 1, or 3 in the expectation pass) fit STACK_BYTES."""
    per = max(1, STACK_BYTES // ((Dpad + 1) * states * P * W * 4))
    return [idxs[i:i + per] for i in range(0, len(idxs), per)]


def _host_map(fn, items: Sequence) -> list:
    """``[fn(x) for x in items]``, on threads past three items: the host
    work is numpy-heavy and independent per item, and threads overlap the
    parts of numpy that release the interpreter lock; order is kept."""
    if len(items) <= 3:
        return [fn(x) for x in items]
    nw = min(8, max(2, (os.cpu_count() or 4) - 2))
    with ThreadPoolExecutor(max_workers=nw) as ex:
        return list(ex.map(fn, items))


def prob_bucket(W: int, P: int, n: int, config: AlignmentConfig,
                site_mode: bool) -> bool:
    """Whether a bucket of ``n`` segments runs on the probability-space
    sweeps: exactly where the JAX runner runs its ``log_space=False``
    kernels (``runner.py:444-448, 513-517``). That is with
    ``PROB_SWITCH`` set to "1", at P = 1, W <= 512, Gaussian emissions,
    no expectation pass, not in site mode (which skips P = 1 segments),
    and for buckets of at least PROB_MIN_BUCKET segments."""
    return (os.environ.get(PROB_SWITCH) == "1" and P == 1
            and W <= bfb.PROB_MAX_W
            and config.emission_mode == bfb.MODE_MEAN_ONLY
            and not config.compute_expectations and not site_mode
            and n >= PROB_MIN_BUCKET)


def rerun_suspects(tasks, seg_results: List[dict], ids: Sequence[int],
                   device: torch.device, threshold: float,
                   verbose: bool = False) -> int:
    """The residual guard of the probability-space sweeps (the JAX
    runner's ``runner.py:596-614``): every segment of ``ids`` whose result
    is flagged ``numerics_suspect`` runs again on the exact, log-space
    sweeps on ``device``, bucket by bucket, and its result is replaced.
    ``tasks[i]`` = (read index, x1, y1, problem, W, Dpad, P). Returns the
    number of segments re-run."""
    rerun = defaultdict(list)
    for i in ids:
        if seg_results[i]["numerics_suspect"]:
            rerun[tuple(tasks[i][4:7])].append(i)
    n = sum(map(len, rerun.values()))
    if verbose:
        print(f"[runner] re-running {n} of {len(ids)} probability-space "
              "segments on the log-space sweeps (numerics residual check)",
              file=sys.stderr)
    for (W, Dpad, P), idxs in rerun.items():
        for chunk in _stack_chunks(idxs, W, Dpad, P):
            res = HopperAligner([tasks[i][3] for i in chunk], W,
                                device).execute(threshold)
            for i, r in zip(chunk, res):
                seg_results[i] = r
    return n


def _site_cells(problem: bfb.BandedProblem, k: int, codes: str) -> np.ndarray:
    """1-based cells x whose k-mer's LAST base is an ambiguity code: the
    only cells that report in MarginalizeFullVariants
    (variantCaller.py:123-187)."""
    seq_b = np.frombuffer(problem.seq.encode(), np.uint8)
    lastb = seq_b[k - 1:k - 1 + problem.lX]
    amb = np.frombuffer(codes.encode(), np.uint8)
    return np.flatnonzero(np.isin(lastb, amb)) + 1


def run_alignment_batch(
    reads_and_guides: Sequence[Tuple[NanoporeReadData, GuideAlignment]],
    reference: ProcessedReference,
    model: PoreModel,
    config: Optional[AlignmentConfig] = None,
    hdp: Optional[NanoporeHDP] = None,
    *,
    device: torch.device = torch.device("cuda"),
    strand_template: bool = True,
    call_variants: Optional[str] = None,
    verbose: bool = False,
    stage_seconds: Optional[Dict[str, float]] = None,
) -> List[ReadAlignment]:
    """Align many reads: prep -> shape buckets -> one ``HopperAligner``
    per bucket on ``device`` -> per-read results (failed reads dropped).
    ``config.emission_mode`` MODE_HDP takes its emissions from ``hdp``
    (the JAX runner's keyword), whose tables go to ``device`` once.

    ``call_variants`` (the candidate bases, e.g. "CT" for the ``Y`` code
    of a CpG motif edition) switches to site-mode calling, as in the JAX
    runner: per-site posterior sums on the device, results carrying
    ``variant_calls`` (the MarginalizeFullVariants per-read table) and
    empty ``aligned_pairs``. Segments with P = 1 hold no site cell and are
    skipped, reporting total_f 0.0 as the JAX runner does.

    ``config.compute_expectations`` runs the EM expectation pass instead
    (``call_variants`` is then ignored, as in the JAX runner): pairs as
    usual, and per read the summed ``transition_expectations`` (3, 3),
    ``emission_expectations`` (3, num_kmers; zeros in MODE_HDP) and
    ``likelihood`` (sum of total_f * n_diag over its segments).

    With ``SIGNALALIGN_TPU_PROB_KERNELS=1`` in the environment (the JAX
    runner's switch) the buckets ``prob_bucket`` admits run on the
    probability-space sweeps, and every segment they flag
    ``numerics_suspect`` is re-run on the log-space sweeps on ``device``
    (the JAX runner's residual guard and exact re-run, ``runner.py:
    596-614``), so the results equal the default run's within f32
    round-off.

    A read whose prep fails (an empty alignment window) is dropped
    (``verbose`` prints a ``FAILED`` line for it), and the rest of the
    batch aligns. An expectation pass runs buckets of any P, as the JAX
    runner's XLA expectation core does (``runner.py:384-391``).
    ``stage_seconds``, when given, receives the wall seconds of each
    stage: "prep" (host), "hdp_upload" (HDP mode: the tables to the
    device), "kernels" (upload, both sweeps, survivor or site-sum fetch,
    expectation sums; ends in a device synchronisation), "decode"
    (survivors to pairs), "rerun" (when the probability-space sweeps ran:
    the flagged segments again, kernels and decode) and "assemble".
    """
    config = config or AlignmentConfig()
    _check_slice(config, hdp)
    config = config.for_batch(len(reads_and_guides))
    expect = config.compute_expectations
    site_mode = call_variants is not None and not expect
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
            return prepare_read(read, guide, reference, model, config, hdp,
                                strand_template=strand_template), None
        except Exception as exc:  # per-read fault isolation
            # (reference: KEY:FAILED handling, signalAlignment.py:627-737)
            return None, f"{type(exc).__name__}: {exc}"

    prep_out = _host_map(prep_one, reads_and_guides)

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
    k = model.kmer_length
    cells = ([_site_cells(t[3], k, "".join(config.ambig_map)) for t in tasks]
             if site_mode else None)
    mark("prep")

    buckets: Dict[Tuple[int, int, int], List[int]] = defaultdict(list)
    for i, t in enumerate(tasks):
        buckets[(t[4], t[5], t[6])].append(i)
    tables = None
    if config.emission_mode == bfb.MODE_HDP:
        tables = hdp_tables(*hdp.density_arrays(), device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mark("hdp_upload")

    seg_results: List[Optional[dict]] = [None] * len(tasks)
    prob_ids: List[int] = []    # segments run in probability space
    for (W, Dpad, P), idxs in buckets.items():
        if site_mode and P == 1:
            # a site cell has >= 2 paths, so a P = 1 segment reports no
            # call and (segment DPs being independent) is not run
            for i in idxs:
                seg_results[i] = {"total_f": 0.0, "total_b": 0.0}
            continue
        prob = prob_bucket(W, P, len(idxs), config, site_mode)
        if prob:
            # the probability-space sweeps' event normaliser, for their
            # buckets alone (host work, booked to the prep)
            _host_map(bfb.event_normaliser, [tasks[i][3] for i in idxs])
            mark("prep")
        for chunk in _stack_chunks(idxs, W, Dpad, P, 3 if expect else 1):
            aligner = HopperAligner([tasks[i][3] for i in chunk], W, device,
                                    tables, expect=expect, log_space=not prob)
            if site_mode:
                res = aligner.site_sums([cells[i] for i in chunk],
                                        config.threshold)
                mark("kernels")
            else:
                arrays = aligner.run(config.threshold)
                mark("kernels")
                res = aligner.decode(arrays)
                mark("decode")
            for i, r in zip(chunk, res):
                seg_results[i] = r
        if prob:
            prob_ids += idxs

    if prob_ids:
        rerun_suspects(tasks, seg_results, prob_ids, device,
                       config.threshold, verbose)
        mark("rerun")

    out: List[ReadAlignment] = []
    k1 = k - 1
    s_lab = "t" if strand_template else "c"
    for read, guide, target, params, events, ev_start, ids in prepped:
        if strand_template:
            fwd_out, ref_shift = guide.output_frame(read.rna)
        else:
            fwd_out = guide.forward
            ref_shift = guide.window_end if guide.forward \
                else guide.window_start
        all_pairs = []
        per_pos = {}    # site mode: (strand, genomic k-mer start) -> {base: p}
        total_lp = 0.0
        gap = 0.0
        texp = np.zeros((3, 3))
        kexp = np.zeros((3, model.alphabet.num_kmers))
        lik = 0.0
        for si in ids:
            _, x1, y1, problem = tasks[si][:4]
            r = seg_results[si]
            total_lp += r["total_f"]
            gap = max(gap, abs(r["total_f"] - r["total_b"]))
            if expect:
                texp += r["texp"]
                kexp += r["kexp"]
                lik += r["total_f"] * problem.n_diag
            if site_mode:
                if "site_probs" not in r:
                    continue
                segm = marginals_from_site_probs(
                    cells[si], r["site_probs"], problem, call_variants)
                for pos_seg, probs in segm.items():
                    gpos = adjust_reference_coordinate(
                        (pos_seg - k1) + x1, ref_shift, len(target), k,
                        strand_template, fwd_out)
                    per_pos[(s_lab, gpos)] = probs
                continue
            for prob, x, y, kmer in r["pairs"]:
                all_pairs.append((prob, x + x1, y + y1, kmer))
        all_pairs.sort(key=lambda r: (r[1] + r[2], r[1]))
        vcalls = (variant_calls_dataframe(per_pos, read.read_label,
                                          guide.contig, fwd_out, call_variants)
                  if site_mode else None)
        out.append(ReadAlignment(
            read_label=read.read_label, contig=guide.contig,
            forward=fwd_out, strand_template=strand_template,
            aligned_pairs=all_pairs, score=posterior_score(all_pairs),
            target=target, event_offset=ev_start, ref_offset=ref_shift,
            params=params, events=events, total_log_prob=total_lp,
            rna=read.rna, max_total_gap=gap, variant_calls=vcalls,
            transition_expectations=texp if expect else None,
            likelihood=lik,
            emission_expectations=kexp if expect else None))
    mark("assemble")
    if stage_seconds is not None:
        stage_seconds.update(stages)
    return out


def write_outputs(results: Sequence[ReadAlignment], model: PoreModel,
                  output_dir: str, output_format: str = "full",
                  variants: Optional[str] = None) -> List[str]:
    """Output files as the JAX ``run_signal_align`` writes them:
    ``<label>.sm.forward|backward.tsv`` (full), ``<label>.sm.vc.tsv``
    (variantCaller), both, ``<label>.sm.assignments.tsv``, or for
    ``variants`` (results of site-mode calling; ``variants`` names the
    candidate bases) ``<label>.sm.variants.tsv`` per read plus
    ``variants_aggregate.tsv`` and ``variants_per_read.tsv``."""
    if output_format not in ("full", "variantCaller", "both", "assignments",
                             "variants"):
        raise ValueError(f"unknown output format {output_format!r}")
    if output_format == "variants" and not variants:
        raise ValueError("output_format='variants' needs the candidate "
                         "bases (variants=...)")
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
        if output_format == "variants" and r.variant_calls is not None:
            path = os.path.join(output_dir, f"{r.read_label}.sm.variants.tsv")
            r.variant_calls.to_csv(path, sep="\t", index=False)
            written.append(path)
    if output_format == "variants":
        import pandas as pd
        frames = [r.variant_calls for r in results
                  if r.variant_calls is not None]
        path = os.path.join(output_dir, "variants_aggregate.tsv")
        aggregate_over_reads(frames, variants).to_csv(path, sep="\t",
                                                      index=False)
        written.append(path)
        # per-read per-strand summary calls (MarginalizeFullVariants
        # per_read_calls, variantCaller.py:176-180)
        path = os.path.join(output_dir, "variants_per_read.tsv")
        per_read_calls_dataframe(
            pd.concat(frames, ignore_index=True) if frames
            else pd.DataFrame(), variants).to_csv(path, sep="\t", index=False)
        written.append(path)
    return written


def align_and_write(
    reads_and_guides: Sequence[Tuple[NanoporeReadData, GuideAlignment]],
    reference: ProcessedReference,
    model: PoreModel,
    output_dir: str,
    config: Optional[AlignmentConfig] = None,
    *,
    output_format: str = "full",
    variants: Optional[str] = None,
    hdp: Optional[NanoporeHDP] = None,
    device: torch.device = torch.device("cuda"),
    verbose: bool = False,
    stage_seconds: Optional[Dict[str, float]] = None,
    results_out: Optional[List[ReadAlignment]] = None,
) -> List[str]:
    """The alignment half of ``run_signal_align``: ``run_alignment_batch``
    on ``device``, then ``write_outputs``. Returns the written files.

    ``output_format="variants"`` runs site-mode calling with the candidate
    bases ``variants`` (e.g. "CT"), derived from ``config.ambig_map`` when
    that offers one set only. ``stage_seconds`` receives the runner's
    stages and "write"; ``results_out``, when given, the read results.
    """
    config = config or AlignmentConfig()
    call_variants = None
    if output_format == "variants":
        if variants is None:
            opts = {v for v in config.ambig_map.values()}
            if len(opts) != 1:
                raise ValueError(
                    "output_format='variants' needs an explicit "
                    f"variants= candidate set (ambig_map offers {opts})")
            variants = opts.pop()
        call_variants = variants
    t0 = time.perf_counter()
    results = run_alignment_batch(reads_and_guides, reference, model, config,
                                  hdp, device=device,
                                  call_variants=call_variants,
                                  verbose=verbose, stage_seconds=stage_seconds)
    if verbose:
        n_events = sum(r.events.shape[0] for r in results)
        print(f"[runner] aligned {len(results)} reads ({n_events} events) "
              f"in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        for r in results:
            # per-read summary (signalMachine.c:917-923 format)
            print(f"[runner] {r.read_label} "
                  f"{len(r.aligned_pairs)}({r.score:.6f})", file=sys.stderr)
    t0 = time.perf_counter()
    written = write_outputs(results, model, output_dir, output_format,
                            variants=variants)
    if stage_seconds is not None:
        stage_seconds["write"] = time.perf_counter() - t0
    if results_out is not None:
        results_out.extend(results)
    return written


def read_fast5(path: str, rec, model: PoreModel,
               quality_threshold: Optional[float] = 7.0,
               force_kmer_event_alignment: bool = False,
               verbose: bool = False) -> NanoporeReadData:
    """One read of ``run`` as the JAX ``run_signal_align``
    loads it (``runner.py:790-808``): ``NanoporeReadData.from_fast5``,
    or, for a fast5 without a usable event table (no basecall events, or
    RNA events in index scale) and with ``force_kmer_event_alignment``,
    the raw signal's kmer-event alignment against the SAM/BAM record
    ``rec``'s sequence under ``model`` (``nanopore_read_from_raw``, which
    embeds the generated table into the fast5). A raw alignment that
    fails QC raises ValueError with its message."""
    try:
        if force_kmer_event_alignment:
            raise ValueError("no basecall events (forced)")
        return NanoporeReadData.from_fast5(
            path, quality_threshold=quality_threshold)
    except ValueError as exc:
        if "no basecall events" not in str(exc) and \
                "index-scale" not in str(exc):
            raise
    if verbose:
        print(f"[runner] {os.path.basename(path)}: no usable event table; "
              "running kmer-event alignment", file=sys.stderr)
    return nanopore_read_from_raw(path, model, rec)


def embed_results(rgs: Sequence[Tuple[NanoporeReadData, GuideAlignment]],
                  results: Sequence[ReadAlignment], model: PoreModel,
                  verbose: bool = False) -> None:
    """``--embed``: each aligned read's full rows with their raw
    coordinates, its MEA labels and its variantCaller rows written into
    its fast5 under /Analyses/SignalAlign_NNN (``io.embed.embed_alignment``,
    as the JAX ``run_signal_align`` does at ``runner.py:890-908``). A read
    whose embedding fails is reported under ``verbose`` and skipped, as
    there."""
    by_label = {read.read_label: read for read, _ in rgs}
    for r in results:
        read = by_label.get(r.read_label)
        if read is None or read.fast5_path is None:
            continue
        try:
            with Fast5(read.fast5_path) as f5:
                raw_events = f5.template_events(read.analysis_path)
            embed_alignment(
                read.fast5_path, r.full_rows(model), raw_events,
                vc_rows=r.vc_rows(model),
                basecall_events_path=(read.analysis_path or "")
                + "/BaseCalled_template/Events")
        except Exception as exc:
            if verbose:
                print(f"[runner] embed failed for {r.read_label}: {exc}",
                      file=sys.stderr)


def run_signal_align(
    alignment_file: str,
    readdb: Optional[str],
    fast5_dirs: Sequence[str],
    reference_fasta: str,
    model: PoreModel,
    output_dir: str,
    config: Optional[AlignmentConfig] = None,
    output_format: str = "full",
    positions=None,
    motifs=None,
    hdp: Optional[NanoporeHDP] = None,
    max_reads: Optional[int] = None,
    quality_threshold: float = 7.0,
    verbose: bool = True,
    embed: bool = False,
    overwrite: bool = True,
    force_kmer_event_alignment: bool = False,
    target_regions=None,
    distributed: bool = False,
    variants: Optional[str] = None,
    device: torch.device = torch.device("cuda"),
) -> List[str]:
    """Full CLI-equivalent run, the JAX ``run_signal_align``: filter reads
    (primary, mapped, SAM quality) -> ``read_fast5`` (the fast5's event
    table, or its raw signal's kmer-event alignment) -> guide from the
    SAM/BAM record -> ``align_and_write`` on ``device``. Returns the
    written files.

    ``positions`` (an ``AmbiguityPositions``) and ``motifs`` edit the
    reference; ``max_reads`` keeps the first reads that pass the filter;
    ``overwrite=False`` skips reads whose outputs exist; a read whose
    guide is invalid, outside ``target_regions``, or whose raw alignment
    fails QC is skipped with its message; a native library that cannot
    be built raises. ``force_kmer_event_alignment``
    aligns every read's raw signal; ``embed`` writes each read's
    alignment into its fast5 (``embed_results``). The ambiguity map is
    ``config.ambig_map``. Without h5py it raises ImportError before any
    file is read.

    ``distributed=True`` (several hosts or GPUs) is not ported yet and
    raises ``NotImplementedError`` naming ROADMAP §1 item 5.
    """
    if distributed:
        raise NotImplementedError(
            "run_signal_align(distributed=True): sharding reads over hosts "
            "or GPUs is not ported yet (ROADMAP §1 item 5)")
    import_h5py()
    config = config or AlignmentConfig()
    reference = ProcessedReference(reference_fasta, positions=positions,
                                   motifs=motifs)
    pairs = filter_reads(alignment_file, readdb, list(fast5_dirs),
                         quality_threshold=quality_threshold)
    if max_reads:
        pairs = pairs[:max_reads]
    if not overwrite:
        # rerun-resume: skip reads whose outputs already exist (the
        # reference's check_for_temp_file_existance behavior,
        # signalAlignment.py:250-260). The skip key is the read_label that
        # names the outputs (the fast5 read id), matched against exact
        # file names: a prefix glob would match labels that prefix others.
        def _done(f5_path, rec):
            try:
                with Fast5(f5_path) as f5:
                    label = f5.read_id or f5_path
            except Exception:
                label = rec.qname
            return any(os.path.exists(os.path.join(output_dir,
                                                   f"{label}.sm.{sfx}.tsv"))
                       for sfx in ("forward", "backward", "vc",
                                   "assignments"))
        pairs = [(f5, rec) for f5, rec in pairs if not _done(f5, rec)]

    rgs = []
    for f5, rec in pairs:
        try:
            read = read_fast5(f5, rec, model, quality_threshold,
                              force_kmer_event_alignment, verbose)
            guide = guide_from_sam_record(rec)
            if guide is None or not guide.validate(read.read_length):
                raise ValueError("invalid guide alignment")
            if target_regions is not None and not target_regions.accepts(guide):
                raise ValueError("alignment outside target regions")
            rgs.append((read, guide))
        except NativeLibraryError:
            raise       # not a fault of this read: every read would skip
        except Exception as exc:
            if verbose:
                print(f"[runner] skipping {f5}: {exc}", file=sys.stderr)
    results: List[ReadAlignment] = []
    written = align_and_write(rgs, reference, model, output_dir, config,
                              output_format=output_format, variants=variants,
                              hdp=hdp, device=device, verbose=verbose,
                              results_out=results)
    if embed:
        embed_results(rgs, results, model, verbose)
    return written


def twod_fast5_paths(fast5_dirs: Sequence[str],
                     max_reads: Optional[int] = None) -> List[str]:
    """The ``*.fast5`` files of ``fast5_dirs``, each directory's sorted,
    the first ``max_reads`` of them."""
    paths = []
    for d in fast5_dirs:
        paths.extend(sorted(glob.glob(os.path.join(d, "*.fast5"))))
    return paths[:max_reads] if max_reads else paths


def read_2d(path: str, reference: ProcessedReference):
    """A 2D read of ``path`` and its guide from ``generate_guide_alignment``
    of its 2D sequence against ``reference``; ValueError if it maps
    nowhere valid."""
    read = NanoporeRead2DData.from_fast5(path)
    guide = generate_guide_alignment(read.twod_sequence, reference)
    if guide is None or not guide.validate(len(read.twod_sequence)):
        raise ValueError("could not map 2D read")
    return read, guide


def align_2d_and_write(
    reads_and_guides: Sequence[Tuple[NanoporeRead2DData, GuideAlignment]],
    reference: ProcessedReference,
    template_model: PoreModel,
    complement_model: PoreModel,
    output_dir: str,
    config: Optional[AlignmentConfig] = None,
    *,
    output_format: str = "full",
    device: torch.device = torch.device("cuda"),
    verbose: bool = False,
    stage_seconds: Optional[Dict[str, float]] = None,
    results_out: Optional[List[ReadAlignment]] = None,
) -> List[str]:
    """The alignment half of ``run_signal_align_2d``: the template strands
    through ``run_alignment_batch`` with the template model, the
    complement strands with the complement model
    (``strand_template=False``), both on ``device``; then one output file
    per read holding both strands, the template's rows first
    (outputAlignment, signalMachine.c:276-309). ``stage_seconds`` receives
    each strand's runner stages (prefixed "template_" and "complement_")
    and "write"; ``results_out``, when given, the template strands'
    results, then the complement strands'."""
    config = config or AlignmentConfig()
    if output_format not in ("full", "variantCaller", "both"):
        raise ValueError(f"2D output format {output_format!r}: full, "
                         "variantCaller or both")
    strand_stages: Dict[str, Dict[str, float]] = {}
    strand_results = []
    for name, model, template in (
            ("template", template_model, True),
            ("complement", complement_model, False)):
        strand_stages[name] = {}
        strand_results.append(run_alignment_batch(
            [(getattr(read, name), guide) for read, guide in reads_and_guides],
            reference, model, config, device=device,
            strand_template=template, verbose=verbose,
            stage_seconds=strand_stages[name]))
    t0 = time.perf_counter()
    by_label: Dict[str, list] = {}
    for t in strand_results[0]:
        by_label[t.read_label] = [t, None]
    for c in strand_results[1]:
        by_label.setdefault(c.read_label, [None, None])[1] = c
    guides = {read.read_label: guide for read, guide in reads_and_guides}
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for label, (t, c) in by_label.items():
        guide = guides.get(label)
        if guide is None:
            continue
        fwd_label = "forward" if guide.forward else "backward"
        path = os.path.join(output_dir, f"{label}.sm.{fwd_label}.tsv")
        vcp = os.path.join(output_dir, f"{label}.sm.vc.tsv")
        if output_format in ("full", "both"):
            write_full_tsv(path, t.full_rows(template_model) if t else [],
                           append=False)
            if c:
                write_full_tsv(path, c.full_rows(complement_model),
                               append=True)
            written.append(path)
        if output_format in ("variantCaller", "both"):
            write_vc_tsv(vcp, t.vc_rows(template_model) if t else [],
                         append=False)
            if c:
                write_vc_tsv(vcp, c.vc_rows(complement_model), append=True)
            written.append(vcp)
    if stage_seconds is not None:
        for name, stages in strand_stages.items():
            stage_seconds.update({f"{name}_{k}": v for k, v in stages.items()})
        stage_seconds["write"] = time.perf_counter() - t0
    if results_out is not None:
        results_out.extend(strand_results[0] + strand_results[1])
    if verbose:
        print(f"[runner2d] aligned {len(by_label)} 2D reads",
              file=sys.stderr)
    return written


def run_signal_align_2d(
    fast5_dirs: Sequence[str],
    reference_fasta: str,
    template_model: PoreModel,
    complement_model: PoreModel,
    output_dir: str,
    config: Optional[AlignmentConfig] = None,
    output_format: str = "full",
    max_reads: Optional[int] = None,
    verbose: bool = True,
    device: torch.device = torch.device("cuda"),
) -> List[str]:
    """2D (template + complement) run over a directory of 2D fast5s, the
    JAX ``run_signal_align_2d`` (``runner.py:913-1004``): each read's 2D
    alignment-table sequence mapped by ``generate_guide_alignment`` (the
    built-in Smith-Waterman or minimizer index in place of bwa), a read
    that does not map skipped with its message (a native library that
    cannot be built raises), then
    ``align_2d_and_write`` on ``device``. Returns the written files.
    Without h5py it raises ImportError before any file is read."""
    import_h5py()
    reference = ProcessedReference(reference_fasta)
    rgs = []
    for f5 in twod_fast5_paths(fast5_dirs, max_reads):
        try:
            rgs.append(read_2d(f5, reference))
        except NativeLibraryError:
            raise
        except Exception as exc:
            if verbose:
                print(f"[runner2d] skipping {f5}: {exc}", file=sys.stderr)
    return align_2d_and_write(
        rgs, reference, template_model, complement_model, output_dir, config,
        output_format=output_format, device=device, verbose=verbose)
