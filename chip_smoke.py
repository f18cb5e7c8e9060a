"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure stops the run with a non-zero exit):
  1. the device: name and power limit (nvidia-smi), torch and CUDA versions;
  2. the kernel build from signalalign_tpu_torch/csrc with nvcc, and the
     latency of one diagonal's synchronisation (csrc/barrier_probe.cu):
     the per-pair and probability-space instances' one barrier at 1 to 16
     warps, the P > 2 instances' two at 1 to 32, the cluster instance's
     two cluster barriers at 2, 4 and 8 blocks of 16 and 32 warps;
  3. each kernel against its plain PyTorch twin on the card, on 8 problems
     of the phase-4 batch (W=256, about 4k diagonals), with its time;
     then the whole main path on the GPU against the CPU (twins) on the
     batch's two shortest reads;
  3c. the kernels with P = 2, 4 and 8 paths per cell against their twins
     on the card, at the shapes phase 5 gives them: one bucket per (W, P)
     class of phase 5's aligners (the class's shortest problem), so that
     every P > 2 instance (cells per thread K = 1, 2, 4, 8) is held, bit
     for bit; with totals, |d exp(fstack)|, the survivor sets with their
     paths, |d posterior| and the times; then a P = 16 segment (two X
     sites in one k-mer of the shortest read) the same way, and that read
     through run_alignment_batch on the GPU against the CPU; then two P =
     1 segments whose band is wider than the per-pair instances take (W =
     2304: the P > 2 instances at P = 1), bit for bit; then the cluster
     instance (past 8,192 cells a diagonal) bit for bit on a P = 64
     segment (three X sites in one k-mer of a 300-base read, W = 256) and
     a P = 16 one at W = 768, and that P = 64 read through
     run_alignment_batch on the GPU (the cluster instance's launches
     counted from 0) against the CPU; then the scratch instance (past the
     cluster instance's CAP) bit for bit on a short P = 64 problem at W =
     1024, and a read with four X sites in one k-mer (P = 256, W = 256)
     through run_alignment_batch on the GPU (the scratch instance's
     launches counted from 0), then its segment bit for bit;
  3d. site-mode calling ("CT") and P > 1 pair output on the GPU against
     the CPU (twins) on the two shortest reads of the phase-5 batch;
  4. the main path at a realistic size: 64 synthetic reads (about 1M
     events, 5-mer ACGT model) through run_alignment_batch on the GPU and
     write_outputs("both"), with the output checks, stage times, events/s
     and peak device memory, and the kernels' launch counts in that run;
  5. site-mode methylation calling at a realistic size: the same 64 reads
     against the CpG edition of the genome (Y at every C of a CG) through
     run_alignment_batch(call_variants="CT") and write_outputs("variants"),
     with the call checks, stage times, events/s, site rows, the bucket mix
     by (W, P), peak device memory and the launch counts of that run;
  5b. both kernels on each phase-5 bucket again, in the runner's chunks,
     timed by CUDA events and summed by (W, P), with their share of
     phase 5's wall time;
  6. HDP methylation calling, the JAX package's flagship workload: a
     6-mer ACEGOT synthetic model (46,656 k-mers), its synthetic HDP on
     the trainer's grid (30-180 pA, 1,200 points; 2 x 224 MB tables) and
     the same 64 reads against the CG -> PG edition (P: C or E):
     6a. both kernels in HDP mode against their twins on the card, one
         bucket per (W, P) class of 6c's aligners (its shortest problem),
         the P > 1 classes bit for bit, with the times;
     6b. HDP calls ("CE") and HDP pair output on the GPU against the CPU
         on the batch's two shortest reads;
     6c. run_alignment_batch(..., hdp=, call_variants="CE") on the 64
         reads and write_outputs("variants"), with the call checks, stage
         times (the HDP table upload among them), events/s, site rows, the
         bucket mix, peak device memory and the launch counts;
     6d. both kernels on each phase-6 bucket by CUDA events, summed by
         (W, P), with their share of 6c's wall time;
  7. EM training (the expectation instances of both kernels, P = 1):
     7a. both expectation kernels against their twins on the card, one
         bucket per W class of 7c's own prep (the class's two shortest
         problems) and one per W class of 7d's, with the times; then the
         eight longest W=256 problems of 7c's prep, expectation and plain
         instances timed on the same problems;
     7b. the expectation pass (texp, kexp, totals) on the GPU against the
         CPU (twins) on the batch's two shortest reads;
     7c. em_train on the 64 reads of phase 4, from the phase-4 model with
         its level means moved by N(0, 1.5 pA) noise: two iterations of
         unified EM (transitions and emissions, prior weight 5) with
         checkpoints and expectations files; the likelihood, transition
         rows, emission recovery and file round-trip checks; stage times
         per iteration, events/s, launch counts, kernel sums by CUDA
         events and peak device memory;
     7d. threeStateHdp transition EM: one iteration over 16 of phase 6's
         reads against the plain genome (every segment P = 1).
  8. the probability-space path (SIGNALALIGN_TPU_PROB_KERNELS=1):
     8a. both probability-space kernels against their twins on phase 3a's
         problems, timed beside the log-space kernels on the same
         problems, with bound and floor; and on problems of eight
         error-free reads (phase 4's reads follow their basecall errors,
         and every segment of theirs exhausts the f32 window, as the JAX
         kernels' do), where the values are held;
     8b. outlier_segments: the two lanes with an outlier run trip, the
         aligner flags them, and the re-run gives them the log-space
         path's results bit for bit;
     8c. phase 4's 64 reads through run_alignment_batch with the switch
         set and write_outputs("both"): the output equals phase 4's, the
         probability-space kernels run on exactly the buckets the runner
         admits and the log-space ones on the rest (W = 768 among them);
         segments flagged and re-run, stage times (rerun among them),
         events/s beside phase 4's, peak device memory, launch counts;
     8d. probability-space against log-space kernel time on every W <= 512
         bucket of phase 4, in the runner's chunks, by CUDA events.
  9. the CLI's `run` from its files (run_signal_align's steps), but the
     fast5 decode: this host has no h5py, so the reads stay in memory and
     the CPU tests hold the fast5 reader against the JAX package's:
     9a. write_synthetic_run writes phase 4's 64 reads' SAM (with a
         secondary, an unmapped and a low-quality record), readdb, FASTA
         and CpG positions file; read_alignment_file, filter_reads' test
         and guide_from_sam_record rebuild every guide, equal to the
         in-memory one; align_and_write(..., "both") on the reference read
         from the written FASTA writes files byte-equal to phase 4's;
     9b. the positions file's edition (ProcessedReference(positions=))
         equals phase 5's motif edition sequence for sequence, and
         align_and_write(..., "variants", variants="CT") writes phase 5's
         files: every column but the C and T probabilities equal, those
         within TOL_ORDER;
     each with its stage seconds, events/s, peak device memory and launch
     counts.
  10. training: the CLI train's steps from its files but the fast5 decode
     (pipeline.train.train_models, as cmd_train calls it), on phase 6's
     6-mer ACEGOT model with its 5-mC k-mers moved 3 pA above their C
     k-mers (methylated_pore_model) and phase 6's read sizes: 96 reads
     drawn twice from one genome, with canonical events and with the
     events of the CG -> EG edition, their SAM and FASTA with C:
     10a. the expectation pass at P > 1 (and at P = 1 past 2,048 cells)
          against the twins, timed by CUDA events beside its bound and the
          plain instances on the same problems: phase 5's W = 256 classes
          of P = 2, 4 and 8, 3c's two P = 1 segments at W = 2304 and its
          wide P = 64 and P = 16 W = 768 segments; on the P > 2 register
          instances' classes (P = 4, 8, and P = 1 at W = 2304) also the
          backward's stored stack against the twin's bit for bit,
          sa_expect_sums against bfb.expectation_sums within TOL_SPLIT,
          two of its launches bit for bit, and the backward and
          sa_expect_sums timed apart;
     10b. one iteration of transitions EM over a canonical sample (32
          reads), a sample whose reference is the CG -> XG edition (32
          reads: P = 4, 16 and 64 buckets) and one whose reference is the
          CCGG -> CPGG edition (8 reads: P = 2 buckets): finite
          likelihood, transition rows summing to 1, the checkpoint and
          expectations file round trip, launches of the P > 2 instances'
          and of the per-pair P = 2 instance's expectation pass, and of
          sa_expect_sums once for each P > 2 register backward;
     10c. hdp_emissions over the canonical sample and an mC sample (32
          reads, motifs CG -> EG): buildAlignment.tsv, the Gibbs trainer
          on a 1,200-point grid (GIBBS_10C), template.nhdp, which loads
          with more than 10 E-k-mers observed;
     10d. HDP calling (C against E on the CG -> PG edition, phase 6c's
          path) with that .nhdp on 16 held-out reads of each sample:
          totals above -1e29, the mC reads' mean p_E above the canonical
          reads';
     each with its stage seconds, events/s, peak device memory and launch
     counts.
  11. the reads `run` and `train` take besides basecalled 1D fast5s, from
     the in-memory twins of their fast5s (utils.synthetic; no h5py here):
     11a. the first 32 of phase 4's reads as raw current (each event
          round(length x 4 kHz) samples at its level) through
          align_raw_signal (trim, t-statistic event detection, method of
          moments scaling, the adaptive banded alignment and its QC), then
          align_and_write(..., "both"): every read past QC, detected
          events within 20% of the drawn ones, pairs in [n/2, 3n],
          |total_f - total_b| < 1 nat; then the first 16 of them again
          with each sample scattered by its event's stdv, as a real
          event's samples are: the detector splits such events, so these
          are held to QC, pairs and totals, their detected / drawn ratio
          reported;
     11c. --embed's tables of 11a's results in memory: the full rows with
          their raw coordinates and the MEA labels;
     11b. 16 2D reads (the template strand under phase 4's model, the
          complement under synthetic_pore_model(1)) on a 400 kb genome,
          mapped by generate_guide_alignment's minimizer index within 50
          b of their drawn windows, both strands through
          align_2d_and_write: the same gates on each strand;
     each with its stage seconds (detect, adaptive align, guide, prep,
     kernels, write), events/s, peak device memory and launch counts.
Each kernel's line carries its bound: the larger of the bytes it must
move over the HBM rate and its transcendentals over the SFU rate, with
the serial-diagonal floor (longest problem's diagonals times the measured
latency of one diagonal's synchronisation at the launched block's warp
count, phase 2) beside it.
The last two lines are a JSON object per kernel and the result line
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero.

    python3 chip_smoke.py --kernel-sums [TREE]

times only the kernels of the port in TREE (a checkout; by default this
one) on phase 3a's problems (plain, expectation and probability-space
instances), on 3c's wide segments (plain and expectation instances), and
on every bucket of phases 4 (plain and expectation instances, and the
probability-space pair on W <= 512), 5 and 6 (every (W, P) class,
Gaussian and HDP), 7c and 10b (the expectation instances on em_train's
and train_models' buckets; 10b summed by instance too, and where the
port's register instances store their stack the backward alone and
sa_expect_sums alone on their buckets), by class, and prints one JSON
line (no result line): run it for two checkouts in turns (A, B, B, A) in
one job to compare their kernels.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# tolerances of kernel against twin (same formulas and rounding, built
# without multiply-add contraction; other order only in the final sums)
TOL_TOTAL = 1e-2        # nats, forward and backward totals
TOL_POST = 1e-4         # absolute, posteriors and exp(normalised forward)
TOL_EDGE = 1e-4         # survivors may differ only this close to threshold
# the main path on the GPU against the CPU: the CPU's exp/log round
# otherwise, and the log terms of a posterior reach ~2^10 nats on these
# reads, where an f32 ulp is 1.2e-4; 1e-3 is 8 such ulps
TOL_PATH = 1e-3
# a site's posterior sum is a float32 index_add_ on the card, whose atomics
# add its cells' posteriors (each <= 1) in no fixed order: two runs differ
# by a few float32 roundings of sums <= ~100, under 1e-5
TOL_ORDER = 1e-5
SEED_MODEL, SEED_READS = 0, 1
AMB = {"Y": "CT"}
AMB_HDP = {"P": "CE"}
SEED_HDP = 2
# least share of sites called C (p_C > 0.5): the reads come from the
# unedited genome, so C is the truth at every site but for read
# substitutions; measured 0.79-0.88 on small batches of these reads on
# the CPU
MIN_SHARE_C = 0.7
# the same for HDP calls (C against E) on the 6-mer ACEGOT model and its
# synthetic HDP: measured 0.857 and 0.827 on two batches of four such
# reads (2,098-2,885 events) on the CPU, 0.794 to 0.893 per read
MIN_SHARE_C_HDP = 0.75
# the expectation kernels against their twins: texp and kx are float64
# sums of float32 per-cell terms exp(f + t + b + normaliser) that the twin
# forms in another association (the XLA core's); the normaliser reaches
# hundreds of nats (~2^10 at most on these reads, as TOL_PATH's terms),
# where an f32 ulp is up to 1.2e-4, so a single term may differ by a few
# 1e-4 relative (measured on an H100: kx 6.1e-5, texp 6.3e-6 at W=128).
# Compared as max |difference| over max |value|; 1e-3 is TOL_PATH's
# 8 ulps
TOL_EXPECT = 1e-3
# sa_expect_sums against its twin (bfb.expectation_sums) on the same
# stacks: both add the same float32 pair terms, in float64 in another
# order (and the into-match posterior's float32 sum over the source paths
# in the same order)
TOL_SPLIT = 1e-6
# the expectation pass on the GPU against the CPU: the tolerances of the
# JAX package's own Pallas-vs-XLA expectation tests
TEXP_TOL = dict(rtol=2e-4, atol=5e-3)
KEXP_TOL = dict(rtol=2e-3, atol=5e-3)
SEED_EM_NOISE = 99      # the level-mean noise of 7c's start model
SEED_CLEAN = 11         # 8a's error-free reads
SEED_WIDE = 12          # 3c's wide P = 1 segments
WIDE_P1_W = 2304        # their bucket width: past the per-pair instances
SEED_X64 = 13           # 3c's P = 64 read
SEED_WIDE16 = 14        # 3c's P = 16 segment at W = 768
SEED_PASTCAP = 17       # 3c's problem and read past the cluster CAP
# the cluster synchronisation probe's cluster sizes and warps a block
CLUSTER_SIZES, CLUSTER_WARPS = (2, 4, 8), (16, 32)
SEED_TRAIN = 15         # phase 10's reads
# phase 10c's Gibbs schedule: the CLI's defaults (burn-in multiplier 32,
# thinning 100) but 15 samples, not 1000, so that 10c fits about 120 s.
# Each sample evaluates every observed k-mer's density on the 1,200-point
# grid and adds the whole 46,657 x 1,200 table (seconds a sample on one
# core), where a burn-in update takes microseconds (tens of seconds for
# the ~450,000 rows of 10c at 32 updates a row)
GIBBS_10C = {"gibbs_samples": 15, "burnin_multiplier": 32, "thinning": 100}
# 10d: the least the mC reads' mean p_E must exceed the canonical reads'
# (0.0202 measured on an H100, PERF.md §6)
SEP_10D = 0.01
EM_SEGMENT_DIAGONALS = 3200   # em_train's segment cap
# phase 11: 11a's reads (the first of phase 4's), the least share of a
# read's drawn events the detector may miss or add, 11b's 2D reads and
# their complement strands' model, and how far (bases) a 2D read's guide
# may end from its drawn window
N_RAW_11A = 32
EVENT_TOL_11A = 0.2
# 11a's noisy reads: how many, and each sample's scatter in its event's
# stdv (synthetic.raw_adc)
N_NOISY_11A = 16
NOISE_11A = 1.0
SEED_2D = 16
SEED_COMPLEMENT = 1
MAP_TOL_11B = 50
# H100 SXM peaks for the bounds: HBM bytes per second, and transcendental
# results per second (16 special-function results per clock per SM, 132
# SMs, 1,980 MHz boost clock)
HBM_BYTES_PER_S = 3.35e12
SFU_PER_S = 16 * 132 * 1.98e9


def wide_p1_problems(bfb, model, ScalingParams, ambig):
    """Two P = 1 segments whose band is wider than the per-pair
    instances take (3c): seeded sequences of 2,500-2,600 bases, events
    drawn from the model's level means (sd 1.2 pA), anchors every 20
    events but for events 150-2,400, over which the band bulges past
    2,048 offsets (the runner's bucket of such a band: W = WIDE_P1_W)."""
    rng = np.random.default_rng(SEED_WIDE)
    out = []
    for i in range(2):
        seq = "".join(rng.choice(list("ACGT"),
                                 size=int(rng.integers(2500, 2600))))
        ids = model.alphabet.seq_to_kmer_ids(seq)
        ev = np.stack([model.level_mean[ids] + rng.normal(0, 1.2, len(ids)),
                       np.ones(len(ids)), np.full(len(ids), .005),
                       np.arange(len(ids)) * .005], 1)
        anchors = [(j, j) for j in range(8, len(ids) - 8, 20)
                   if not 150 < j < 2400]
        out.append(bfb.prepare_problem(
            seq, ev, model, ScalingParams(shift=0.1 * i), ambig,
            W=WIDE_P1_W, Dpad=6144, P=1, anchor_pairs=anchors, expansion=10,
            mode=bfb.MODE_MEAN_ONLY))
    return out


def x_read(model, plain, tmp, n_x, seed=SEED_X64):
    """The plain genome edited with ``n_x`` X (ACGT) sites in one k-mer,
    and a 300-base read over them drawn from the plain genome: ((read,
    guide), the edited reference). Its one segment has 4^n_x paths per
    cell at W = 256: three X sites 64 (16,384 cells a diagonal, the
    cluster instance), four 256 (65,536: past the cluster instance's CAP,
    the scratch instance)."""
    from signalalign_tpu_torch.io.reference import ProcessedReference
    from signalalign_tpu_torch.utils.synthetic import (synthetic_read,
                                                       write_genome_fasta)
    site = len(plain) // 2
    fa = os.path.join(tmp, f"x{n_x}.fa")
    write_genome_fasta(plain[:site] + "X" * n_x + plain[site + n_x:], fa)
    rg = synthetic_read(np.random.default_rng(seed), plain, model,
                        site - 150, 300, f"x{4 ** n_x}")
    return rg, ProcessedReference(fa)


def pastcap_problems(bfb, model, ScalingParams, ambig):
    """3c's short problem past the cluster instance's CAP: 100 seeded
    bases with an XGXGX cluster (P = 64) at 40, events drawn from the
    resolved sequence (sd 1.2 pA), anchors every 20 events, at W = 1024
    (65,536 cells a diagonal: the scratch instance), ~200 diagonals."""
    rng = np.random.default_rng(SEED_PASTCAP)
    seq = list(rng.choice(list("ACGT"), size=100))
    seq[40:45] = "XGXGX"
    seq = "".join(seq)
    ids = model.alphabet.seq_to_kmer_ids(seq.replace("X", "A"))
    ev = np.stack([model.level_mean[ids] + rng.normal(0, 1.2, len(ids)),
                   np.ones(len(ids)), np.full(len(ids), .005),
                   np.arange(len(ids)) * .005], 1)
    anchors = [(j, j) for j in range(8, len(ids) - 8, 20)]
    return [bfb.prepare_problem(seq, ev, model, ScalingParams(), ambig,
                                W=1024, Dpad=256, P=64, anchor_pairs=anchors,
                                expansion=10, mode=bfb.MODE_MEAN_ONLY)]


def wide_p16_problems(bfb, model, ScalingParams, ambig):
    """3c's P = 16 segment past 8,192 cells a diagonal: 640 seeded bases
    with a Y every 25 positions and one YYGYY cluster, events drawn from a
    resolved sequence (sd 1.2 pA), anchors every 15 events but for events
    40-600, over which the band bulges past 512 offsets (W = 768: 12,288
    cells, the wide instance)."""
    rng = np.random.default_rng(SEED_WIDE16)
    seq = list(rng.choice(list("ACGT"), size=640))
    for j in range(8, 632, 25):
        seq[j] = "Y"
    seq[318:323] = "YYGYY"
    seq = "".join(seq)
    ids = model.alphabet.seq_to_kmer_ids(seq.replace("Y", "C"))
    ev = np.stack([model.level_mean[ids] + rng.normal(0, 1.2, len(ids)),
                   np.ones(len(ids)), np.full(len(ids), .005),
                   np.arange(len(ids)) * .005], 1)
    anchors = [(j, j) for j in range(8, len(ids) - 8, 15)
               if not 40 < j < 600]
    return [bfb.prepare_problem(seq, ev, model, ScalingParams(), ambig,
                                W=768, Dpad=1536, P=16, anchor_pairs=anchors,
                                expansion=8, mode=bfb.MODE_MEAN_ONLY)]


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, by CUDA events. Two
    untimed calls come first and their outputs are held together, so that
    the caching allocator holds the blocks the timed calls reuse: a
    cudaMalloc inside the timed window stalls the stream (the likely cause
    of one run's 3a forward at 11.0 ms, where other runs read 4.2-4.8 ms,
    and of single-launch bucket times 15-70% above the same bucket's in
    other runs)."""
    warm = [fn(), fn()]
    del warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def survivors(slot_cell, slot_val, cnt, R):
    """{(problem, diagonal, cell o*P + p): posterior} of the first cnt
    slots."""
    keep = torch.arange(R, device=cnt.device) < cnt[:, :, None]
    b, d, _ = keep.nonzero(as_tuple=True)
    o = slot_cell[keep]
    v = slot_val[keep]
    return {(int(bi), int(di), int(oi)): float(vi) for bi, di, oi, vi in
            zip(b.tolist(), d.tolist(), o.tolist(), v.tolist())}


def compare_calls(a, b):
    """Max |dp_C| of two variant-call tables with the same rows in order."""
    check(list(zip(a["strand"], a["position"]))
          == list(zip(b["strand"], b["position"])), "site rows differ")
    return float(np.abs(a["C"].to_numpy() - b["C"].to_numpy()).max()) \
        if len(a) else 0.0


def same_files(got, want):
    """How many of two runs' written files (the same names, in order) are
    equal byte for byte."""
    check([os.path.basename(p) for p in got]
          == [os.path.basename(p) for p in want],
          f"file names differ: {len(got)} files against {len(want)}")
    n = 0
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            n += fa.read() == fb.read()
    return n


def compare_variant_files(got, want):
    """(files equal byte for byte, max |d p| of the C and T columns) of two
    runs' variants files; every other column must be equal."""
    import pandas as pd
    n_same = same_files(got, want)
    worst = 0.0
    for a, b in zip(got, want):
        ga, wb = pd.read_csv(a, sep="\t"), pd.read_csv(b, sep="\t")
        check(list(ga.columns) == list(wb.columns) and len(ga) == len(wb),
              f"{os.path.basename(a)}: columns or rows differ")
        for c in ga.columns:
            if c in ("C", "T"):
                if len(ga):
                    worst = max(worst, float(np.abs(ga[c] - wb[c]).max()))
            else:
                check(ga[c].tolist() == wb[c].tolist(),
                      f"{os.path.basename(a)}: column {c} differs")
    return n_same, worst


def kernels_vs_twins(hk, bfb, pt, threshold, R, reps=5):
    """Both kernels against their twins on one bucket; fails beyond the
    tolerances, and for P > 1 unless every output is equal bit for bit
    (fstack rows, offsets, the totals' log-sum terms, survivor counts,
    cells and posteriors). Returns the kernels' mean CUDA-event times over
    ``reps`` launches after two warm-up calls, the twins' times, the
    errors and the survivor counts."""
    dev = pt.device
    nds = pt.meta[:, bfb.M_NDIAG]
    t0 = time.perf_counter()
    f_ref, fi_ref, lf_ref = hk.forward_sweep_ref(pt)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t0) * 1e3
    fwd_ms, (f_k, fi_k, lf_k) = cuda_ms(lambda: hk.forward_sweep(pt), reps)
    _, tf_k = bfb.forward_offsets(fi_k, lf_k, nds)
    fo_ref, tf_ref = bfb.forward_offsets(fi_ref, lf_ref, nds)
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    equal = (torch.equal(f_k[rows], f_ref[rows])
             and torch.equal(fi_k[rows], fi_ref[rows])
             and torch.equal(lf_k, lf_ref))
    fdiff = (f_k.exp() - f_ref.exp()).abs().amax(dim=(2, 3))[rows].max().item()
    tf_err = (tf_k - tf_ref).abs().max().item()
    check(tf_err <= TOL_TOTAL and fdiff <= TOL_POST,
          f"sa_fwd_sweep (P={pt.P}) disagrees with forward_sweep_ref: "
          f"|d total_f| {tf_err}, |d exp(fstack)| {fdiff}")
    cvecf = (fo_ref - tf_ref[:, None]).contiguous()
    t0 = time.perf_counter()
    bref = hk.backward_sweep_compact_ref(pt, f_ref, cvecf, threshold, R)
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t0) * 1e3
    bwd_ms, bk = cuda_ms(lambda: hk.backward_sweep_compact(
        pt, f_ref, cvecf, threshold, R), reps)
    _, tb_k = bfb.backward_offsets(bk[0], bk[1])
    _, tb_ref = bfb.backward_offsets(bref[0], bref[1])
    tb_err = (tb_k - tb_ref).abs().max().item()
    check(int(bk[4].max()) <= R, "survivor slots overflowed")
    sk = survivors(*bk[2:], R)
    sr = survivors(*bref[2:], R)
    for key in set(sk) ^ set(sr):
        p = sk.get(key, sr.get(key))
        check(abs(p - threshold) <= TOL_EDGE, f"survivor {key} p={p} on one side only")
    pdiff = max(abs(sk[k] - sr[k]) for k in set(sk) & set(sr))
    check(tb_err <= TOL_TOTAL and pdiff <= TOL_POST,
          f"sa_bwd_sweep_compact (P={pt.P}) disagrees with its twin: "
          f"|d total_b| {tb_err}, |d posterior| {pdiff}")
    equal = (equal and torch.equal(bk[0][rows], bref[0][rows])
             and torch.equal(bk[1], bref[1])
             and torch.equal(bk[4][rows], bref[4][rows]) and sk == sr)
    check(equal or pt.P == 1, f"the P={pt.P} kernels (W={pt.W}) differ from "
          "their twins: not bit for bit")
    return {"fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms, "bwd_ms": bwd_ms,
            "bwd_plain_ms": bwd_plain_ms, "tf_err": tf_err, "tb_err": tb_err,
            "fdiff": fdiff, "pdiff": pdiff, "n_kernel": len(sk),
            "n_twin": len(sr), "paths": sorted({c % pt.P for _, _, c in sk}),
            "bit_equal": equal}


def expect_vs_twins(hk, bfb, pt, threshold, R, reps=5):
    """Both expectation instances against their twins on one bucket: the
    three-state stacks, offsets, totals and survivors must be equal bit
    for bit, texp and kx (float64 sums of float32 terms, formed in another
    association by the twin) within TOL_EXPECT of the twin's relative to
    their largest value. On a bucket of the P > 2 register instances
    (``hk.expect_split``) the backward's wrapper runs the backward, which
    stores its three-state stack, then sa_expect_sums: the stack must
    equal the twin's ``store_full`` stack bit for bit, sa_expect_sums on
    it the twin's sums within TOL_SPLIT, and two of its launches the same
    bits; the backward alone and sa_expect_sums alone are timed too.
    Returns the kernels' times (3a's method), the twins' wall times, the
    errors and the survivor count."""
    dev = pt.device
    nds = pt.meta[:, bfb.M_NDIAG]
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    split = hk.expect_split(pt.W, pt.P)
    tol = TOL_SPLIT if split else TOL_EXPECT
    t0 = time.perf_counter()
    fr = hk.forward_sweep_ref(pt, expect=True)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t0) * 1e3
    fwd_ms, fk = cuda_ms(lambda: hk.forward_sweep(pt, expect=True), reps)
    check(torch.equal(fk[0][rows], fr[0][rows])
          and torch.equal(fk[1][rows], fr[1][rows])
          and torch.equal(fk[2], fr[2]),
          f"sa_fwd_sweep (expect) differs from its twin (W={pt.W})")
    fo, tf = bfb.forward_offsets(fr[1], fr[2], nds)
    cvecf = (fo - tf[:, None]).contiguous()
    # the twin: the backward keeping its stack, then the sums
    # (backward_sweep_compact_ref's two steps, timed apart)
    t0 = time.perf_counter()
    stack_ref = hk.backward_sweep_stack_ref(pt, fr[0], cvecf, threshold, R)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bo_ref, _ = bfb.backward_offsets(stack_ref[0], stack_ref[1])
    sums_ref = hk.expect_sums_ref(pt, fr[0], stack_ref[5], cvecf, bo_ref)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    br = stack_ref[:5] + sums_ref
    bwd_plain_ms = (t2 - t0) * 1e3
    bwd_ms, bk = cuda_ms(lambda: hk.backward_sweep_compact(
        pt, fr[0], cvecf, threshold, R, expect=True), reps)
    sk, sr = survivors(*bk[2:5], R), survivors(*br[2:5], R)
    check(torch.equal(bk[0][rows], br[0][rows]) and torch.equal(bk[1], br[1])
          and sk == sr, f"sa_bwd_sweep_compact (expect) offsets, totals or "
          f"survivors differ from its twin (W={pt.W})")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()
    texp_rel = rel(bk[5], br[5])
    hdp = pt.hdp is not None
    kx_rel = 0.0 if hdp else rel(bk[6], br[6])
    check(texp_rel <= tol and kx_rel <= tol
          and (not hdp or not bk[6].any()),
          f"expectation sums differ from the twin's (W={pt.W}, P={pt.P}, "
          f"HDP {hdp}): texp {texp_rel:.3e}, kx {kx_rel:.3e} (tol {tol})")
    out = {"fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms, "bwd_ms": bwd_ms,
           "bwd_plain_ms": bwd_plain_ms, "texp_rel": texp_rel,
           "kx_rel": kx_rel,
           "texp_abs": (bk[5] - br[5]).abs().max().item(),
           "kx_abs": (bk[6] - br[6]).abs().max().item(), "n_kernel": len(sk),
           "texp_sum": br[5].sum().item(), "split": split}
    if not split:
        return out
    stack_ms, st = cuda_ms(lambda: hk.backward_sweep_stack(
        pt, fr[0], cvecf, threshold, R), reps)
    check(torch.equal(st[5][rows], stack_ref[5][rows]),
          f"the stored backward stack differs from the twin's (W={pt.W}, "
          f"P={pt.P})")
    bo, _ = bfb.backward_offsets(st[0], st[1])
    sums_ms, s1 = cuda_ms(lambda: hk.expect_sums(pt, fr[0], st[5], cvecf,
                                                 bo), reps)
    s2 = hk.expect_sums(pt, fr[0], st[5], cvecf, bo)
    torch.cuda.synchronize()
    check(torch.equal(s1[0], s2[0]) and torch.equal(s1[1], s2[1]),
          f"two launches of sa_expect_sums differ (W={pt.W}, P={pt.P})")
    s_texp, s_kx = rel(s1[0], sums_ref[0]), 0.0 if hdp else rel(s1[1],
                                                                 sums_ref[1])
    check(s_texp <= TOL_SPLIT and s_kx <= TOL_SPLIT,
          f"sa_expect_sums differs from its twin (W={pt.W}, P={pt.P}, HDP "
          f"{hdp}): texp {s_texp:.3e}, kx {s_kx:.3e} (tol {TOL_SPLIT})")
    out.update({"stack_ms": stack_ms, "sums_ms": sums_ms,
                "stack_plain_ms": (t1 - t0) * 1e3,
                "sums_plain_ms": (t2 - t1) * 1e3,
                "sums_abs": max((s1[0] - sums_ref[0]).abs().max().item(),
                                (s1[1] - sums_ref[1]).abs().max().item()),
                "sums_texp_rel": s_texp, "sums_kx_rel": s_kx})
    return out


def prob_vs_twins(hk, bfb, pt, threshold, R, reps=5):
    """Both probability-space kernels against their twins on one P = 1
    bucket: the same lanes trip (totals not within 1 nat); on the others
    totals within TOL_TOTAL, exp(fstack) and the survivors' posteriors
    within TOL_POST, the survivor sets equal but for threshold-edge cells.
    Returns the kernels' times (3a's method), the twins' wall times, the
    errors, the survivor counts and the tripped lanes."""
    dev = pt.device
    nds = pt.meta[:, bfb.M_NDIAG]
    rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
    t0 = time.perf_counter()
    fr = hk.forward_sweep_prob_ref(pt)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t0) * 1e3
    fwd_ms, fk = cuda_ms(lambda: hk.forward_sweep_prob(pt), reps)
    fo, tf_r = bfb.forward_offsets(fr[1], fr[2], nds)
    _, tf_k = bfb.forward_offsets(fk[1], fk[2], nds)
    cvecf = (fo - tf_r[:, None]).contiguous()
    t0 = time.perf_counter()
    br = hk.backward_sweep_compact_prob_ref(pt, fr[0], cvecf, threshold, R)
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t0) * 1e3
    bwd_ms, bk = cuda_ms(lambda: hk.backward_sweep_compact_prob(
        pt, fr[0], cvecf, threshold, R), reps)
    _, tb_r = bfb.backward_offsets(br[0], br[1])
    _, tb_k = bfb.backward_offsets(bk[0], bk[1])
    ok = (tf_r - tb_r).abs() < 1.0
    check(torch.equal((tf_k - tb_k).abs() < 1.0, ok),
          f"probability-space kernels trip other lanes than their twins: "
          f"kernel {(tf_k - tb_k).tolist()}, twin {(tf_r - tb_r).tolist()}")
    out = {"fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms, "bwd_ms": bwd_ms,
           "bwd_plain_ms": bwd_plain_ms, "tripped": (~ok).tolist(),
           "tf_err": 0.0, "tb_err": 0.0, "fdiff": 0.0, "pdiff": 0.0,
           "n_kernel": 0, "n_twin": 0}
    if not ok.any():
        return out
    live = rows & ok[:, None]
    out["fdiff"] = (fk[0].exp() - fr[0].exp())[:, :, 0][live].abs().max().item()
    out["tf_err"] = (tf_k - tf_r)[ok].abs().max().item()
    out["tb_err"] = (tb_k - tb_r)[ok].abs().max().item()
    check(int(bk[4][ok].max()) <= R, "survivor slots overflowed")
    # the tripped lanes' slots are left out
    sk = survivors(bk[2], bk[3], torch.where(ok[:, None], bk[4], 0), R)
    sr = survivors(br[2], br[3], torch.where(ok[:, None], br[4], 0), R)
    for key in set(sk) ^ set(sr):
        p = sk.get(key, sr.get(key))
        check(abs(p - threshold) <= TOL_EDGE, f"survivor {key} p={p} on one side only")
    out["pdiff"] = max((abs(sk[k] - sr[k]) for k in set(sk) & set(sr)),
                       default=0.0)
    check(out["tf_err"] <= TOL_TOTAL and out["tb_err"] <= TOL_TOTAL
          and out["fdiff"] <= TOL_POST and out["pdiff"] <= TOL_POST,
          f"probability-space kernels disagree with their twins (W={pt.W}): "
          f"{ {k: out[k] for k in ('tf_err', 'tb_err', 'fdiff', 'pdiff')} }")
    out["n_kernel"], out["n_twin"] = len(sk), len(sr)
    return out


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def sweep_bounds(bfb, pt, n_surv, expect=False, prob=False):
    """Least times in ms, and what sets them, of the two sweeps on ``pt``'s
    problems: the larger of the bytes each must move over the HBM rate, and
    the transcendentals its in-band cells need over the SFU rate.

    Bytes: every input read once over each problem's own extents (x0 and
    width up to n_diag, the reference rows and legality masks over reflen,
    the event rows over evlen; of the reference rows only m_hat and inv_m
    in HDP mode, plus the k-mer ids and level means and one 16-byte knot
    pair per distinct k-mer of a valid slot), every output written once
    (the forward's fstack rows up to n_diag, the backward's ``n_surv``
    survivor slots), and the backward's read of fstack only at in-band
    cells. Transcendentals: counted per in-band cell from the kernels'
    formulas (two per logaddexp, one per posterior and per HDP spline; the
    backward evaluates two splines a cell, its stay and its match-to as a
    target). The function needs the source terms once per cell, and each
    logsumexp one exponential per legal path pair of these problems'
    legality masks plus one logarithm where a path is legal; that is
    counted at every P > 1, whichever instance the P is dispatched to.
    ``expect``: the expectation instances, which write (and
    read at in-band cells) three states per diagonal, compute seven more
    exponentials per in-band cell (the transitions out of a source cell,
    through its to-cell reductions) and write texp (B, 7) and kx (B, 3,
    P, reflen) in float64; at P > 1 with Gaussian emissions also each
    target's into-match posterior, a logsumexp over its legal source
    paths. ``prob``: the probability-space kernels (P = 1),
    which read three reference rows, the two exp-constant rows, the
    best-case event row and a second pack and no legality masks, and
    spend two exponentials and a logarithm per in-band cell forward, and
    those and the posterior's exponential backward. With ``expect`` also
    sa_expect_sums, the sums of a P > 2 register instance's bucket from
    both stacks: each stack read once at in-band cells (out of the band
    every value is the NEG constant, as in the backward's fstack read),
    the inputs of the emissions, texp and kx written once; five
    exponentials per legal (source, target) pair of an in-band TO cell
    (the forward's count), two per cell for the stays and an HDP spline's
    logarithm. The backward's bound stays that of the whole expectation
    pass (backward and sums)."""
    B, D1 = pt.x0.shape
    P, W = pt.P, pt.W
    x0 = pt.x0.cpu().numpy()
    width = pt.width.cpu().numpy()
    meta = pt.meta.cpu().numpy()
    NW = bfb.leg_words(P)
    leg = pt.leg.cpu().numpy().view(np.uint32).reshape(B, -1, P, NW)
    hdp = pt.hdp is not None
    cells = rows = ref_cols = ev_cols = 0
    lse = {0: [0, 0], 1: [0, 0]}   # forward, backward: [exps, logs]
    o = np.arange(W)
    for b in range(B):
        n = int(meta[b, bfb.M_NDIAG]) + 1
        w = width[b, :n]
        cells += int(w.sum())
        rows += n
        ref_cols += int(meta[b, bfb.M_REFLEN])
        ev_cols += int(meta[b, bfb.M_EVLEN])
        if P > 1:
            inb = o[None, :] < w[:, None]
            for sweep in (0, 1):   # the forward reads column x, the backward x+1
                x = np.clip((x0[b, :n, None] + o[None, :] + sweep)[inb], 0,
                            leg.shape[1] - 1)
                masks = leg[b, x]                 # (in-band cells, P, NW)
                if sweep:
                    # backward: a source path's legal targets, the bits of
                    # the target masks' union
                    lse[1][0] += int(_POPCOUNT8[masks.view(np.uint8)].sum())
                    union = np.bitwise_or.reduce(masks, axis=1)
                    lse[1][1] += int(_POPCOUNT8[union.view(np.uint8)].sum())
                else:              # forward: a target path's legal sources
                    per_cell = _POPCOUNT8[masks.view(np.uint8)].reshape(
                        -1, P, 4 * NW).sum(axis=2)
                    lse[0][0] += int(per_cell.sum())
                    lse[0][1] += int((per_cell > 0).sum())
    n_ref_rows = 2 if hdp else bfb.NREF
    in_bytes = (2 * rows * 4                           # x0, width
                + n_ref_rows * P * ref_cols * 4        # ref rows
                + ref_cols * P * NW * 4                # legality masks
                + bfb.NEV * ev_cols * 4                # event rows
                + B * (bfb.NMETA + bfb.NPACK) * 4)     # meta, par
    if prob:
        # ref rows 0, 1, 3 and the two exp-constant rows; the event rows
        # and the best-case row; meta and both packs
        in_bytes = (2 * rows * 4 + 5 * ref_cols * 4
                    + (bfb.NEV + 1) * ev_cols * 4
                    + B * (bfb.NMETA + 2 * bfb.NPACK) * 4)
    if hdp:
        in_bytes += 2 * P * ref_cols * 4               # k-mer ids, means
        cols = torch.arange(pt.kid.shape[2], device=pt.kid.device)
        valid = (pt.ref[:, 1] > 0) & (
            cols < pt.meta[:, bfb.M_REFLEN, None, None])
        in_bytes += int(torch.unique(pt.kid[valid]).numel()) * 16
    states = 3 if expect else 1
    fwd_bytes = in_bytes + states * rows * P * W * 4 + B * D1 * 4 + B * 4
    bwd_bytes = in_bytes + states * cells * P * 4 + rows * 8 + 2 * B * D1 * 4 \
        + B * 4 + n_surv * 8
    if expect:
        bwd_bytes += B * 7 * 8 + 3 * P * ref_cols * 8  # texp, kx
    cp = cells * P
    # the two logsumexps over legal paths of each cell (none at P = 1)
    fwd_ops = cp * 8 + 2 * sum(lse[0]) + (cp if hdp else 0)
    bwd_ops = cp * 9 + 2 * sum(lse[1]) + (2 * cp if hdp else 0) \
        + (7 * cp if expect else 0)
    if expect and P > 1 and not hdp:
        # a target's into-match posterior over its legal source paths: a
        # logsumexp of their terms and one exponential
        bwd_ops += lse[1][0] + 2 * cp
    names = ("sa_fwd_sweep", "sa_bwd_sweep_compact")
    if prob:
        fwd_ops, bwd_ops = 3 * cp, 4 * cp
        names = ("sa_fwd_sweep_prob", "sa_bwd_sweep_compact_prob")
    bounds = [(names[0], fwd_bytes, fwd_ops), (names[1], bwd_bytes, bwd_ops)]
    if expect:
        pairs = lse[0][0] if P > 1 else cp
        sums_bytes = (in_bytes + 2 * 3 * cells * P * 4 + 2 * rows * 8
                      + B * 7 * 8 + (0 if hdp else 3 * P * ref_cols * 8))
        bounds.append(("sa_expect_sums", sums_bytes,
                       5 * pairs + 2 * cp + (cp if hdp else 0)))
    out = {}
    for name, nbytes, ops in bounds:
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / SFU_PER_S
        out[name] = (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else
                     "operations")
    return out


def barrier_latency_us(cuda_build):
    """Microseconds of one diagonal's synchronisation in the sweeps,
    measured by csrc/barrier_probe.cu with one block per SM: {(step,
    warps): us}, step "one" (the per-pair and probability-space
    instances: the warp maxima double-buffered, one barrier) at 1 to 16
    warps, "two" (the P > 2 instances: a block max reduction and a second
    barrier) at 1 to 32 warps; and {("cluster", C, warps): us}, the
    cluster instance's (each warp's max stored to every block of the
    cluster, a cluster barrier, the max over the C x warps slots, a second
    cluster barrier) at C = CLUSTER_SIZES blocks of CLUSTER_WARPS warps."""
    lib = cuda_build.load()
    out = torch.empty(132, device="cuda")
    iters = 20000
    lat = {}
    stream = torch.cuda.current_stream().cuda_stream
    for one, top in ((1, 16), (0, 32)):
        for warps in range(1, top + 1):
            def probe():
                rc = lib.sa_barrier_probe(132, 32 * warps, iters, one,
                                          out.data_ptr(), stream)
                check(rc == 0, f"sa_barrier_probe launch failed: CUDA error "
                      f"{rc}")
            ms, _ = cuda_ms(probe, 3)
            lat[("one" if one else "two", warps)] = 1e3 * ms / iters
    for C in CLUSTER_SIZES:
        for warps in CLUSTER_WARPS:
            def probe():
                rc = lib.sa_barrier_probe_cluster(132 // C, 32 * warps, iters,
                                                  C, out.data_ptr(), stream)
                check(rc == 0, f"sa_barrier_probe_cluster launch failed: "
                      f"CUDA error {rc}")
            ms, _ = cuda_ms(probe, 3)
            lat[("cluster", C, warps)] = 1e3 * ms / iters
    return lat


def block_warps(hk, W, P, expect=False, backward=False):
    """The key in ``barrier_latency_us``'s table of the instance the
    forward (or ``backward``) sweep launches for a bucket of P paths at
    width W: a per-pair instance's one barrier at ceil(P W / K) threads, a
    P > 2 instance's two at min(P W, 1024), or the cluster instance's
    two cluster barriers at its C blocks of its threads."""
    k = hk.cells_per_thread(W, P, expect, backward)
    check(k != 0, f"the sweeps take no bucket of P={P} at W={W}")
    if k > 0:
        return "one", -(-(-(-P * W // k)) // 32)
    C = hk.cluster_ctas(W, P, expect, backward) if k < -8 else 0
    if C:
        return "cluster", C, hk.cluster_threads(W, P, expect, backward) // 32
    return "two", min(32, -(-P * W // 32))


def serial_floor_ms(hk, barrier, pt, expect=False, prob=False,
                    backward=False):
    """The serial-diagonal floor of a sweep on a bucket: its longest
    problem's diagonals times one diagonal's synchronisation at the
    block's warp count (the probability-space kernels: one barrier, W
    threads)."""
    key = (("one", -(-pt.W // 32)) if prob
           else block_warps(hk, pt.W, pt.P, expect, backward))
    check(key in barrier, f"no synchronisation latency measured for {key}")
    return 1e-3 * barrier[key] * max(pt.n_diag)


def sweep_ms(hk, bfb, pt, threshold, R, reps, expect=False, prob=False,
             split=None):
    """Mean CUDA-event milliseconds (forward, backward) of both kernels on
    ``pt`` over ``reps`` launches each, after two warm-up calls; with
    ``expect`` their expectation instances, with ``prob`` the
    probability-space kernels (``pt`` made with ``prob=True``). With a
    dict ``split``, on a bucket whose expectation backward stores its
    stack for sa_expect_sums (``hk.expect_split``, where the port has it),
    also the backward alone and sa_expect_sums alone, in ``split["stack"]``
    and ``split["sums"]`` (the backward's time is both together)."""
    # the argument goes in only when set, so that --kernel-sums also runs
    # a port whose functions predate it
    kw = {"expect": True} if expect else {}
    fwd, bwd = ((hk.forward_sweep_prob, hk.backward_sweep_compact_prob)
                if prob else (hk.forward_sweep, hk.backward_sweep_compact))
    f_ms, (f, fi, lf) = cuda_ms(lambda: fwd(pt, **kw), reps)
    fo, tf = bfb.forward_offsets(fi, lf, pt.meta[:, bfb.M_NDIAG])
    cvecf = (fo - tf[:, None]).contiguous()
    b_ms, _ = cuda_ms(lambda: bwd(pt, f, cvecf, threshold, R, **kw), reps)
    if (split is not None and expect and hasattr(hk, "expect_split")
            and hk.expect_split(pt.W, pt.P)):
        split["stack"], st = cuda_ms(lambda: hk.backward_sweep_stack(
            pt, f, cvecf, threshold, R), reps)
        bo, _ = bfb.backward_offsets(st[0], st[1])
        split["sums"], _ = cuda_ms(lambda: hk.expect_sums(pt, f, st[5], cvecf,
                                                          bo), reps)
    return f_ms, b_ms


def chunk_sums(hk, bfb, problem_tensors, chunks, dev, threshold, R,
               tables=None, expect=False, split=None):
    """Both kernels on every chunk again ([(W, P, problems)], the runner's
    aligners), timed by CUDA events (one launch each after two warm-up
    calls): {(W, P): [problems, fwd ms, bwd ms, [(us per diagonal of each
    launch's longest problem, fwd, bwd)]]}. ``expect``: the expectation
    instances; a dict ``split`` gathers {(W, P): [launches, backward alone
    ms, sa_expect_sums ms]} of the buckets whose backward stores its stack
    for sa_expect_sums (``sweep_ms``)."""
    # the tables and the expectation arguments go in only when given, so
    # that --kernel-sums also runs a port whose functions predate them
    extra = () if tables is None else (tables,)
    by_wp = {}
    for W, P, probs in chunks:
        ptb = problem_tensors(probs, W, dev, *extra,
                              **({"kmer_ids": True} if expect else {}))
        sp = {} if split is not None else None
        f_ms, b_ms = sweep_ms(hk, bfb, ptb, threshold, R, 1, expect,
                              split=sp)
        if sp:
            e = split.setdefault((W, P), [0, 0.0, 0.0])
            e[0] += 1
            e[1] += sp["stack"]
            e[2] += sp["sums"]
        # one block per problem: a launch lasts about as long as its
        # longest problem
        nd = max(ptb.n_diag)
        e = by_wp.setdefault((W, P), [0, 0.0, 0.0, []])
        e[0] += len(probs)
        e[1] += f_ms
        e[2] += b_ms
        e[3].append((1e3 * f_ms / nd, 1e3 * b_ms / nd))
    return by_wp


def bucket_chunks(stack_chunks, buckets, expect=False):
    """{(W, Dpad, P): problems} cut into the runner's chunks (three stack
    rows per diagonal with ``expect``): [(W, P, problems)]."""
    return [(W, P, [probs[i] for i in chunk])
            for (W, Dpad, P), probs in sorted(buckets.items())
            for chunk in stack_chunks(list(range(len(probs))), W, Dpad, P,
                                      3 if expect else 1)]


def kernel_sums(hk, bfb, problem_tensors, stack_chunks, buckets, dev,
                threshold, R, tables=None, expect=False, split=None):
    """``chunk_sums`` over {(W, Dpad, P): problems} cut into the runner's
    chunks."""
    return chunk_sums(hk, bfb, problem_tensors,
                      bucket_chunks(stack_chunks, buckets, expect), dev,
                      threshold, R, tables, expect, split)


class Recorder:
    """Within ``with``, every aligner the runner makes is recorded in
    ``made`` as (W, P, problems, log_space), in order: the buckets and
    chunks of a main-path run, without a second host prep."""

    def __init__(self, runner_mod):
        self.mod = runner_mod
        self.made = []

    def __enter__(self):
        self.orig = base = self.mod.HopperAligner
        made = self.made

        class Recording(base):
            def __init__(self, problems, W, device, *args, **kw):
                super().__init__(problems, W, device, *args, **kw)
                made.append((W, self.pt.P, list(problems), self.log_space))

        self.mod.HopperAligner = Recording
        return self

    def __exit__(self, *exc):
        self.mod.HopperAligner = self.orig

    def chunks(self, made=None):
        return [(W, P, probs) for W, P, probs, _ in
                (self.made if made is None else made)]

    def classes(self, made=None):
        """{(W, P): problems}, shortest first."""
        out = {}
        for W, P, probs, _ in (self.made if made is None else made):
            out.setdefault((W, P), []).extend(probs)
        return {k: sorted(v, key=lambda q: q.n_diag) for k, v in out.items()}

    def buckets(self):
        """{(W, Dpad, P): problems} (Dpad from each problem's geometry)."""
        out = {}
        for W, P, probs, _ in self.made:
            for q in probs:
                out.setdefault((W, q.x0.shape[0] - 1, P), []).append(q)
        return out


def log_kernel_sums(tag, by_wp, wall_s):
    for (W, P), (n, f_ms, b_ms, us) in sorted(by_wp.items()):
        uf, ub = [u for u, _ in us], [u for _, u in us]
        log(f"[{tag}] kernels W={W} P={P}: {n} problems, fwd {f_ms:.3f} ms, "
            f"bwd {b_ms:.3f} ms; us per diagonal of each launch's longest "
            f"problem fwd {min(uf):.2f}..{max(uf):.2f}, bwd "
            f"{min(ub):.2f}..{max(ub):.2f}")
    f_sum = sum(e[1] for e in by_wp.values())
    b_sum = sum(e[2] for e in by_wp.values())
    log(f"[{tag}] kernel sums fwd {f_sum:.3f} ms, bwd {b_sum:.3f} ms: "
        f"{(f_sum + b_sum) / 1e3 / wall_s:.4f} of run_alignment_batch's "
        f"wall time (sums of CUDA-event times, not a trace)")


def prepare_all(rgs, reference, model, config, hdp=None):
    """[(W, Dpad, P, problem)] of every segment of every read, in read
    order: the host prep of run_alignment_batch, on as many threads."""
    from signalalign_tpu_torch.pipeline.runner import prepare_read
    nw = min(8, max(2, (os.cpu_count() or 4) - 2))
    extra = () if hdp is None else (hdp,)    # as in kernel_sums
    with ThreadPoolExecutor(max_workers=nw) as ex:
        preps = list(ex.map(lambda rg: prepare_read(
            rg[0], rg[1], reference, model, config, *extra), rgs))
    return [(W, Dpad, P, prob) for prep in preps
            for _, prob, W, Dpad, P in prep[4]]


def long_p1_problems(rgs, reference, model, config):
    """Phase 3a's problems: the batch's first eight W=256 P=1 problems of
    3,500 or more diagonals (about 4k), in read order."""
    from signalalign_tpu_torch.pipeline.runner import prepare_read
    picked = []
    for read, guide in rgs:
        segs = prepare_read(read, guide, reference, model, config)[4]
        picked += [p for _, p, W, Dpad, _ in segs
                   if W == 256 and Dpad == 4096 and p.n_diag >= 3500]
        if len(picked) >= 8:
            break
    check(len(picked) >= 8, "batch has fewer than 8 W=256 ~4k-diagonal problems")
    return picked[:8]


def device_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def hdp_batch(tmp):
    """Phase 6's configuration: the 6-mer ACEGOT model, its synthetic HDP
    and the 64 reads with the CG -> PG edition of their genome; returns
    (model, HDP, reads, plain reference, edited reference, config)."""
    from signalalign_tpu_torch.ops import banded_fb as bfb
    from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
    from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                       synthetic_hdp,
                                                       synthetic_pore_model)
    model6 = synthetic_pore_model(SEED_MODEL, alphabet="ACEGOT", k=6)
    hdp6 = synthetic_hdp(model6, SEED_HDP)
    _, plain6, rgs6, ref6, _ = build_synthetic_batch(
        model6, n_reads=64, ev_min=2000, ev_max=50000, seed=SEED_READS,
        genome_len=400_000, fasta_path=os.path.join(tmp, "genome6.fa"),
        ambig_frac=1.0, ambig_motif=("CG", "PG"))
    cfg6 = AlignmentConfig(emission_mode=bfb.MODE_HDP,
                           ambig_map=AMB_HDP).for_batch(len(rgs6))
    return model6, hdp6, rgs6, plain6, ref6, cfg6


def by_class_json(by_wp):
    """{"W,P": [problems, fwd ms, bwd ms, fwd us per diagonal (min, max),
    bwd us per diagonal (min, max)]} of a ``chunk_sums`` result."""
    out = {}
    for (W, P), (n, f_ms, b_ms, us) in sorted(by_wp.items()):
        uf, ub = [u for u, _ in us], [u for _, u in us]
        out[f"{W},{P}"] = [n, f_ms, b_ms, [min(uf), max(uf)],
                           [min(ub), max(ub)]]
    return out


def kernel_sums_of_tree(tree):
    """``--kernel-sums [TREE]``: the kernels of the port in TREE (a
    checkout; by default this one), timed by CUDA events on phase 3a's
    problems (mean of 5 launches after two warm-up calls; the plain,
    expectation and probability-space instances) and on every bucket of
    phases 4 (plain and expectation instances; the probability-space pair
    on W <= 512), 5 (Gaussian, plain and expectation instances), 6 (HDP)
    and 7c and 10b (expectation instances; 10b's segments by (W, P) and
    its sums by instance: per-pair, P > 2 register, wide cluster, wide
    scratch, and in a port whose register instances store their stack
    the backward alone and sa_expect_sums on their buckets), one launch
    each, summed as in 5b and by (W, P) class.
    Prints one JSON line and no result line. It also times the wide
    instances (P * W > 8192; plain and EXPECT, mean of 5 launches) on 3c's
    P = 64 and P = 16 W = 768 segments. Run it for two checkouts in turns
    (A, B, B, A) in one job on one card to compare their kernels."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: --kernel-sums needs a CUDA GPU")
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import signalalign_tpu_torch
    check(os.path.abspath(signalalign_tpu_torch.__file__).startswith(
        os.path.join(tree, "signalalign_tpu_torch")),
        f"imported {signalalign_tpu_torch.__file__}, not the port in {tree}")
    from signalalign_tpu_torch.convert import hdp_tables, problem_tensors
    from signalalign_tpu_torch.ops import banded_fb as bfb
    from signalalign_tpu_torch.ops import banded_fb_hopper as hk
    from signalalign_tpu_torch.pipeline.runner import _stack_chunks
    from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
    from signalalign_tpu_torch.utils import cuda_build
    from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                       synthetic_pore_model)
    dev = torch.device("cuda")
    cuda_build.load()
    model = synthetic_pore_model(SEED_MODEL)
    with tempfile.TemporaryDirectory() as tmp:
        _, reference, rgs, amb_ref, _ = build_synthetic_batch(
            model, n_reads=64, ev_min=2000, ev_max=50000, seed=SEED_READS,
            genome_len=400_000, fasta_path=os.path.join(tmp, "genome.fa"),
            ambig_frac=1.0)
        model6, hdp6, rgs6, _, ref6, cfg6 = hdp_batch(tmp)
    config = AlignmentConfig()
    threshold = config.threshold
    R = hk.survivor_slots(threshold)
    out = {"tree": tree, "device": device_line()}
    p3 = long_p1_problems(rgs, reference, model, config)
    pt = problem_tensors(p3, 256, dev)
    out["3a_fwd_ms"], out["3a_bwd_ms"] = sweep_ms(hk, bfb, pt, threshold, R, 5)
    pt = problem_tensors(p3, 256, dev, kmer_ids=True)
    out["3a_expect_fwd_ms"], out["3a_expect_bwd_ms"] = sweep_ms(
        hk, bfb, pt, threshold, R, 5, expect=True)
    pt = problem_tensors(p3, 256, dev, prob=True)
    out["3a_prob_fwd_ms"], out["3a_prob_bwd_ms"] = sweep_ms(
        hk, bfb, pt, threshold, R, 5, prob=True)
    del pt
    # the wide instance on 3c's segments (a tree whose port refuses them
    # records null)
    from signalalign_tpu_torch.models.pore_model import ScalingParams
    from signalalign_tpu_torch.pipeline.runner import prepare_read
    from signalalign_tpu_torch.utils.alphabet import DEFAULT_AMBIG_BASES
    with tempfile.TemporaryDirectory() as tmp:
        rg64, ref64 = x_read(model, reference.forward["synth"], tmp, 3)
        try:
            wide = [(W, [q]) for _, q, W, _, P in prepare_read(
                *rg64, ref64, model, config)[4] if P == 64]
            wide.append((768, wide_p16_problems(bfb, model, ScalingParams,
                                                DEFAULT_AMBIG_BASES)))
            for W, probs in wide:
                pt = problem_tensors(probs, W, dev)
                out[f"wide_p{pt.P}_w{W}_fwd_ms"], \
                    out[f"wide_p{pt.P}_w{W}_bwd_ms"] = sweep_ms(
                        hk, bfb, pt, threshold, R, 5)
                pt = problem_tensors(probs, W, dev, kmer_ids=True)
                out[f"wide_p{pt.P}_w{W}_expect_fwd_ms"], \
                    out[f"wide_p{pt.P}_w{W}_expect_bwd_ms"] = sweep_ms(
                        hk, bfb, pt, threshold, R, 5, expect=True)
                out[f"wide_p{pt.P}_w{W}_n_diag"] = max(pt.n_diag)
                del pt
        except NotImplementedError as exc:
            out["wide"] = f"refused: {exc}"
    tables = hdp_tables(*hdp6.density_arrays(), dev)
    for phase, rgs_, ref, model_, cfg, tb in (
            ("4", rgs, reference, model, config.for_batch(len(rgs)), None),
            ("5", rgs, amb_ref, model,
             AlignmentConfig(ambig_map=AMB).for_batch(len(rgs)), None),
            ("6", rgs6, ref6, model6, cfg6, tables)):
        buckets = {}
        for W, Dpad, P, prob in prepare_all(rgs_, ref, model_, cfg, hdp6
                                            if tb is not None else None):
            buckets.setdefault((W, Dpad, P), []).append(prob)
        by_wp = kernel_sums(hk, bfb, problem_tensors, _stack_chunks, buckets,
                            dev, threshold, R, tb)
        out[f"phase{phase}_fwd_sum_ms"] = sum(e[1] for e in by_wp.values())
        out[f"phase{phase}_bwd_sum_ms"] = sum(e[2] for e in by_wp.values())
        out[f"phase{phase}_buckets"] = len(buckets)
        out[f"phase{phase}_by_W_P"] = by_class_json(by_wp)
        if phase == "4":
            by_wp = kernel_sums(hk, bfb, problem_tensors, _stack_chunks,
                                buckets, dev, threshold, R, expect=True)
            out["phase4_expect_fwd_sum_ms"] = sum(e[1] for e in by_wp.values())
            out["phase4_expect_bwd_sum_ms"] = sum(e[2] for e in by_wp.values())
            # the probability-space pair on the W <= 512 buckets (8d)
            pf = pb = 0.0
            for W, P, probs in bucket_chunks(_stack_chunks, buckets):
                if W <= bfb.PROB_MAX_W:
                    f_ms, b_ms = sweep_ms(hk, bfb, problem_tensors(
                        probs, W, dev, prob=True), threshold, R, 1, prob=True)
                    pf, pb = pf + f_ms, pb + b_ms
            out["phase4_prob_fwd_sum_ms"] = pf
            out["phase4_prob_bwd_sum_ms"] = pb
        if phase == "5":
            # the expectation pass on phase 5's P > 1 buckets (a tree
            # whose port refuses them records why)
            try:
                by_wp = kernel_sums(hk, bfb, problem_tensors, _stack_chunks,
                                    buckets, dev, threshold, R, expect=True)
                out["phase5_expect_fwd_sum_ms"] = sum(
                    e[1] for e in by_wp.values())
                out["phase5_expect_bwd_sum_ms"] = sum(
                    e[2] for e in by_wp.values())
                out["phase5_expect_by_W_P"] = by_class_json(by_wp)
            except NotImplementedError as exc:
                out["phase5_expect"] = f"refused: {exc}"
        del buckets, by_wp
    # the expectation instances on em_train's own buckets (7c: segments of
    # at most EM_SEGMENT_DIAGONALS diagonals)
    em_cfg = dataclasses.replace(
        config, compute_expectations=True,
        max_segment_diagonals=EM_SEGMENT_DIAGONALS).for_batch(len(rgs))
    buckets = {}
    for W, Dpad, P, prob in prepare_all(rgs, reference, model, em_cfg):
        buckets.setdefault((W, Dpad, P), []).append(prob)
    by_wp = kernel_sums(hk, bfb, problem_tensors, _stack_chunks, buckets, dev,
                        threshold, R, expect=True)
    out["phase7c_expect_fwd_sum_ms"] = sum(e[1] for e in by_wp.values())
    out["phase7c_expect_bwd_sum_ms"] = sum(e[2] for e in by_wp.values())
    out["phase7c_by_W_P"] = by_class_json(by_wp)
    del buckets, by_wp
    # 10b's EM buckets: train_models' transitions EM over the canonical,
    # CG -> XG and CCGG -> CPGG samples (one run_alignment_batch each, as
    # run_alignment_batch_grouped runs them), from the in-memory reads and
    # guides train_phases writes to its SAMs
    from signalalign_tpu_torch.pipeline.train import sample_reference
    with tempfile.TemporaryDirectory() as tmp:
        model10, fa10, ref10, _, samples10 = em10b_samples(tmp)
        segs, inst, merged, split10 = {}, {}, {}, {}
        for name, (rgs_, extra) in samples10.items():
            ref = sample_reference({"name": name, **extra}, ref10, fa10)
            buckets = {}
            for W, Dpad, P, prob in prepare_all(rgs_, ref, model10,
                                                em_cfg.for_batch(len(rgs_))):
                buckets.setdefault((W, Dpad, P), []).append(prob)
                segs[f"{W},{P}"] = segs.get(f"{W},{P}", 0) + 1
            by_wp = kernel_sums(hk, bfb, problem_tensors, _stack_chunks,
                                buckets, dev, threshold, R, expect=True,
                                split=split10)
            for (W, P), e in by_wp.items():
                m = merged.setdefault((W, P), [0, 0.0, 0.0, []])
                m[0] += e[0]
                m[1] += e[1]
                m[2] += e[2]
                m[3] += e[3]
                for bwd in (0, 1):
                    i = inst.setdefault(sweep_instance(hk, W, P, True, bwd),
                                        {"launches": [0, 0], "ms": [0.0, 0.0]})
                    i["launches"][bwd] += len(e[3])
                    i["ms"][bwd] += e[1 + bwd]
            del buckets, by_wp
    out["10b_segments_by_W_P"] = segs
    # a tree whose register instances store their stack: the backward
    # alone and sa_expect_sums alone on those buckets (the "P > 2
    # register" backward sum is both together)
    if split10:
        inst["P > 2 register, backward alone"] = {
            "launches": [0, sum(e[0] for e in split10.values())],
            "ms": [0.0, sum(e[1] for e in split10.values())]}
        inst["sa_expect_sums"] = {
            "launches": [0, sum(e[0] for e in split10.values())],
            "ms": [0.0, sum(e[2] for e in split10.values())]}
        out["10b_split_by_W_P"] = {f"{W},{P}": e
                                   for (W, P), e in sorted(split10.items())}
    # {instance: {"launches": [fwd, bwd], "ms": [fwd sum, bwd sum]}}
    out["10b_expect_by_instance"] = inst
    out["10b_expect_fwd_sum_ms"] = sum(e[1] for e in merged.values())
    out["10b_expect_bwd_sum_ms"] = sum(e[2] for e in merged.values())
    out["10b_by_W_P"] = by_class_json(merged)
    log(json.dumps(out))


def sweep_instance(hk, W, P, expect, backward):
    """The instance the forward (or ``backward``) sweep runs on a bucket,
    by name; a tree without the cluster instance runs every wide bucket on
    its scratch instance."""
    k = hk.cells_per_thread(W, P, expect, backward)
    if k > 0:
        return f"per-pair P = {P}"
    if k >= -8:
        return "P > 2 register"
    if hasattr(hk, "cluster_ctas") and hk.cluster_ctas(W, P, expect,
                                                       backward):
        return "wide cluster"
    return "wide scratch"


def em10b_samples(tmp, n_reads=96, ev_min=2000, ev_max=50000,
                  genome_len=400_000):
    """Phase 10b's model, genome and EM samples: the 6-mer ACEGOT model
    with 5-mC levels 3 pA above C's, the genome's FASTA (written in
    ``tmp``) and reference, the canonical reads and guides drawn from it,
    and {name: (reads and guides, the sample's settings)} of the
    canonical (canonical reads [0, 2g)), CG -> XG ([2g, 4g)) and CCGG ->
    CPGG ([4g, 4.5g)) samples, g = n_reads / 6: what ``train_phases``
    trains on and ``--kernel-sums`` times."""
    from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                       methylated_pore_model,
                                                       synthetic_pore_model)
    g = n_reads // 6
    model10 = methylated_pore_model(
        synthetic_pore_model(SEED_MODEL, alphabet="ACEGOT", k=6))
    fa10 = os.path.join(tmp, "genome10.fa")
    can10, ref10 = build_synthetic_batch(
        model10, n_reads=n_reads, ev_min=ev_min, ev_max=ev_max,
        seed=SEED_TRAIN, genome_len=genome_len, fasta_path=fa10)[:2]
    return model10, fa10, ref10, can10, {
        "canonical": (can10[:2 * g], {}),
        "x": (can10[2 * g:4 * g], {"motifs": [["CG", "XG"]]}),
        "p": (can10[4 * g:4 * g + g // 2], {"motifs": [["CCGG", "CPGG"]]})}


def train_phases(dev, tmp, phase_mark, n_reads=96, ev_min=2000,
                 ev_max=50000, genome_len=400_000, gibbs=None):
    """Phases 10b-10d on ``dev`` (the CPU rehearses them at a small size):
    the CLI train's steps from its files but the fast5 decode, as
    ``cmd_train`` calls them (``pipeline.train.train_models``), on
    ``n_reads`` reads of the 6-mer ACEGOT model with 5-mC levels 3 pA
    above C's (``methylated_pore_model``), drawn twice from one genome:
    with canonical events, and with the events of the CG -> EG edition.
    Of g = n_reads / 6: the canonical sample is canonical reads [0, 2g),
    the CG -> XG sample [2g, 4g), the CCGG -> CPGG sample (P = 2 at each
    site) [4g, 4.5g), the mC sample mC reads [3g, 5g), and 10d holds out
    canonical [4g, 5g) and mC [5g, 6g). Returns 10b's EXPECT launches of
    the P > 2 instances and of the per-pair instance at P = 2, by
    kernel, and its launches of sa_expect_sums."""
    from signalalign_tpu_torch.io.guide import guide_from_sam_record
    from signalalign_tpu_torch.io.reference import ProcessedReference
    from signalalign_tpu_torch.io.sam import passes_filter, read_alignment_file
    from signalalign_tpu_torch.models.expectations import \
        ExpectationsAccumulator
    from signalalign_tpu_torch.models.hdp_model import load_nhdp
    from signalalign_tpu_torch.models.pore_model import PoreModel
    from signalalign_tpu_torch.ops import banded_fb as bfb
    from signalalign_tpu_torch.ops import banded_fb_hopper as hk
    from signalalign_tpu_torch.pipeline import runner as runner_mod
    from signalalign_tpu_torch.pipeline.runner import run_alignment_batch
    from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
    from signalalign_tpu_torch.pipeline.train import (sample_reference,
                                                      train_models)
    from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                       write_synthetic_run)
    gibbs = gibbs or GIBBS_10C
    g = n_reads // 6
    cuda = dev.type == "cuda"

    def reset_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    phase_mark("10b")
    # ---- 10b. the CLI train's steps from its files but the fast5s
    # (train_models, as cmd_train calls it): one iteration of
    # transitions EM over a canonical sample and a sample whose
    # reference is the CG -> XG edition (P > 1 buckets), on the 6-mer
    # ACEGOT model with 5-mC levels a few pA off C's
    t0 = time.perf_counter()
    model10, fa10, _, can10, samples10 = em10b_samples(
        tmp, n_reads, ev_min, ev_max, genome_len)
    # the same reads with their events drawn from the CG -> EG edition
    mc10 = build_synthetic_batch(
        model10, n_reads=n_reads, ev_min=ev_min, ev_max=ev_max,
        seed=SEED_TRAIN, genome_len=genome_len, fasta_path=fa10,
        event_motif=("CG", "EG"))[0]
    reads10 = {r.read_label: r for r, _ in can10}
    sample_sets = {name: rgs_ for name, (rgs_, _) in samples10.items()}
    sample_sets["mc"] = mc10[3 * g:5 * g]
    files10 = {name: write_synthetic_run(
        rgs_, os.path.join(tmp, f"train_{name}"), fa10, fast5=False)
        for name, rgs_ in sample_sets.items()}
    t_files = time.perf_counter() - t0
    t0 = time.perf_counter()
    reads_by_sample = {}
    for name, f in files10.items():
        by_label = (reads10 if name != "mc"
                    else {r.read_label: r for r, _ in mc10})
        records = [rec for rec in read_alignment_file(f["sam"])[1]
                   if passes_filter(rec)]
        rgs_ = [(by_label[rec.qname], guide_from_sam_record(rec))
                for rec in records]
        check([r.read_label for r, _ in rgs_]
              == [r.read_label for r, _ in sample_sets[name]]
              and all(gd.validate(r.read_length) for r, gd in rgs_),
              f"sample {name}: the SAM's reads or guides differ")
        reads_by_sample[name] = rgs_
    ref10 = ProcessedReference(files10["canonical"]["fasta"])
    t_inputs = time.perf_counter() - t0

    motifs = {name: extra["motifs"] for name, (_, extra) in samples10.items()
              if extra}
    motifs["mc"] = [["CG", "EG"]]

    def train_steps(cfg, names):
        samples = [{"name": n, **({"motifs": motifs[n]} if n in motifs
                                  else {})}
                   for n in names]
        srefs = [sample_reference(s, ref10, fa10) for s in samples]
        by_s = [reads_by_sample[n] for n in names]
        trip = [(r, gd, srefs[i]) for i, lst in enumerate(by_s)
                for r, gd in lst]
        out_dir = os.path.join(tmp, "train_out_" + "_".join(names))
        stages = {}
        with Recorder(runner_mod) as rec:
            out = train_models(cfg, samples, srefs, trip, by_s, ref10,
                               model10, out_dir, 1, device=dev,
                               stage_seconds=stages)
        return out, stages, rec, sum(r.n_events for r, *_ in trip)

    hk.reset_launch_counts()
    reset_peak()
    t0 = time.perf_counter()
    out10b, st10b, rec10b, ev10b = train_steps(
        {"training": {"transitions": True}}, ["canonical", "x", "p"])
    t10b = time.perf_counter() - t0
    train_launches = {
        "sa_fwd_sweep": hk.forward_sweep.expect_launches,
        "sa_bwd_sweep_compact": hk.backward_sweep_compact.expect_launches}
    train_paths = {
        "sa_fwd_sweep": hk.forward_sweep.expect_paths_launches,
        "sa_bwd_sweep_compact":
            hk.backward_sweep_compact.expect_paths_launches}
    train_pair2 = {
        "sa_fwd_sweep": hk.forward_sweep.expect_pair2_launches,
        "sa_bwd_sweep_compact":
            hk.backward_sweep_compact.expect_pair2_launches}
    train_wide = {name: {"cluster": fn.cluster_launches,
                         "scratch": fn.wide_scratch_launches}
                  for name, fn in (("sa_fwd_sweep", hk.forward_sweep),
                                   ("sa_bwd_sweep_compact",
                                    hk.backward_sweep_compact))}
    # sa_expect_sums: once for each backward of the P > 2 register
    # instances (the P > 2 instances' launches less the wide ones')
    train_sums = hk.expect_sums.launches
    reg_bwd = train_paths["sa_bwd_sweep_compact"] - sum(
        train_wide["sa_bwd_sweep_compact"].values())
    peak = peak_gib()
    em10 = out10b["em"]
    ll10 = em10.log_likelihoods[0]
    check(np.isfinite(ll10) and ll10 > -1e29,
          f"10b log-likelihood {ll10}")
    tr10 = em10.transitions_history[0]
    check(np.allclose(tr10.sum(axis=1), 1.0, rtol=1e-9),
          f"10b transition rows do not sum to 1: {tr10}")
    wp10 = {k_: len(v) for k_, v in rec10b.classes().items()}
    # (the CPU rehearsal runs the twins, which launch nothing)
    check(any(P_ > 2 for _, P_ in wp10) and any(P_ == 2 for _, P_ in wp10)
          and (not cuda or all(train_paths.values())
               and all(train_pair2.values())
               and train_sums == reg_bwd > 0),
          f"10b ran no P = 2 or no P > 2 expectation bucket: {wp10}, "
          f"{train_launches} (P > 2 instances {train_paths}, per-pair "
          f"P = 2 {train_pair2}), or sa_expect_sums did not run once per "
          f"register backward ({train_sums} for {reg_bwd})")
    # the files: the checkpoint holds the trained transitions, the
    # expectations file gives them back, the final model is the
    # checkpoint's
    ck10 = PoreModel.from_file(em10.checkpoint_files[0])
    acc10 = ExpectationsAccumulator(model10)
    check(acc10.add_file(em10.expectations_files[0]),
          "10b wrote no expectations file")
    d_ck = float(np.abs(ck10.transitions - tr10.reshape(-1)).max())
    d_file = float(np.abs(acc10.normalize_transitions().reshape(-1)
                          - ck10.transitions).max())
    fin10 = PoreModel.from_file(out10b["model_path"])
    check(d_ck <= 1e-6 and d_file <= 1e-6
          and np.array_equal(fin10.transitions, ck10.transitions),
          f"10b files: checkpoint {d_ck}, expectations file {d_file}")
    log(f"[train em] {sum(len(v) for v in reads_by_sample.values())} "
        f"reads in 4 samples' files ({t_files:.2f} s written, SAM and "
        f"guides {t_inputs:.2f} s); canonical + CG -> XG + CCGG -> CPGG "
        f"samples: "
        f"{ev10b} events, log-likelihood {ll10:.2f}, transitions m->m "
        f"{tr10[0, 0]:.5f}; checkpoint |d| {d_ck:.1e}, expectations "
        f"file |d| {d_file:.1e}")
    log("[train em] segments by (W, P): " + " ".join(
        f"{w},{p}:{n}" for (w, p), n in sorted(wp10.items())))
    log("[train em] stages " + " ".join(
        f"{s_}={v:.2f}s" for s_, v in st10b.items()))
    log(f"[train em] {t10b:.2f} s: {ev10b / t10b:.0f} events/s; peak "
        f"device memory {peak:.2f} GiB; launches "
        f"{train_launches} (P > 2 instances {train_paths}, of them wide "
        f"by instance {train_wide}, per-pair P = 2 {train_pair2}); "
        f"sa_expect_sums {train_sums}")

    phase_mark("10c")
    # ---- 10c. hdp_emissions: each sample's observations on its own
    # edition, buildAlignment.tsv, the Gibbs trainer, template.nhdp
    hk.reset_launch_counts()
    reset_peak()
    t0 = time.perf_counter()
    out10c, st10c, _, ev10c = train_steps(
        {"training": {"transitions": False, "hdp_emissions": True,
                      "hdp_type": "singleLevelFixed", **gibbs},
         "hdp_args": {"grid_length": 1200}},
        ["canonical", "mc"])
    t10c = time.perf_counter() - t0
    obs_launches = {"sa_fwd_sweep": hk.forward_sweep.launches,
                    "sa_bwd_sweep_compact":
                        hk.backward_sweep_compact.launches}
    peak = peak_gib()
    with open(out10c["build_alignment"]) as fh:
        kmers10 = [line.split("\t", 1)[0] for line in fh]
    hdp10 = load_nhdp(out10c["nhdp"])
    a10 = hdp10.alphabet
    n_e_obs = sum(1 for i in np.flatnonzero(hdp10.observed)
                  if "E" in a10.index_to_kmer(int(i)))
    n_e_rows = sum("E" in k_ for k_ in kmers10)
    check(n_e_obs > 10 and len(hdp10.grid) == 1200
          and (not cuda or all(obs_launches.values())),
          f"10c: {n_e_obs} E-k-mers observed, grid {len(hdp10.grid)}, "
          f"launches {obs_launches}")
    sh_rows, sh_dens, n_sh = level_shifts(out10c["build_alignment"], hdp10)
    log(f"[train hdp] E above C per E base, over {n_sh} k-mer pairs "
        f"observed in both: the rows {sh_rows:.4f} pA, the trained "
        f"densities' means {sh_dens:.4f} pA (drawn 3 pA)")
    log(f"[train hdp] canonical + mC samples, {ev10c} events: "
        f"{len(kmers10)} buildAlignment rows ({n_e_rows} E-labelled), "
        f"{int(hdp10.observed.sum())} k-mers observed ({n_e_obs} with E)"
        f", grid {len(hdp10.grid)}; Gibbs {gibbs}")
    log("[train hdp] stages " + " ".join(
        f"{s_}={v:.2f}s" for s_, v in st10c.items()))
    log(f"[train hdp] {t10c:.2f} s: {ev10c / t10c:.0f} events/s "
        f"(the alignments alone {ev10c / st10c['observations']:.0f}); "
        f"peak device memory {peak:.2f} GiB; launches "
        f"{obs_launches}")

    phase_mark("10d")
    # ---- 10d. HDP calling with the trained .nhdp on phase 6c's path
    # (CG -> PG edition, C against E) on g held-out reads of each
    # sample
    held = can10[4 * g:5 * g] + mc10[5 * g:]
    ref10p = ProcessedReference(fa10, motifs=[("CG", "PG")])
    cfg10 = AlignmentConfig(emission_mode=bfb.MODE_HDP,
                            ambig_map=AMB_HDP).for_batch(len(held))
    hk.reset_launch_counts()
    reset_peak()
    stages = {}
    t0 = time.perf_counter()
    res10 = run_alignment_batch(held, ref10p, model10, cfg10, hdp10,
                                device=dev, call_variants="CE",
                                stage_seconds=stages)
    t10d = time.perf_counter() - t0
    call_launches = {"sa_fwd_sweep": hk.forward_sweep.launches,
                     "sa_bwd_sweep_compact":
                         hk.backward_sweep_compact.launches}
    peak = peak_gib()
    check(len(res10) == len(held), f"10d: {len(held) - len(res10)} "
          "reads failed")
    n_rows10, _ = check_calls(res10, ref10p.forward["synth"],
                              model10.kmer_length, "P", "CE")
    p_e = [float(r.variant_calls["E"].mean()) for r in res10]
    pe_c, pe_m = float(np.mean(p_e[:g])), float(np.mean(p_e[g:]))
    # a trainer whose E and C densities are equal gives p_E = 0.5 at
    # every site of both samples; SEP_10D asks for more than that
    check(pe_m - pe_c >= SEP_10D
          and (not cuda or all(call_launches.values())),
          f"10d: mean p_E of the mC reads {pe_m} is not {SEP_10D} above "
          f"the canonical reads' {pe_c}; launches {call_launches}")
    ev10d = sum(r.n_events for r, _ in held)
    log(f"[train call] {g} + {g} held-out reads, {ev10d} events, "
        f"{n_rows10} site rows: mean p_E canonical {pe_c:.4f}, mC "
        f"{pe_m:.4f}; totals > -1e29")
    log("[train call] stages " + " ".join(
        f"{s_}={v:.2f}s" for s_, v in stages.items()))
    log(f"[train call] {t10d:.2f} s: {ev10d / t10d:.0f} events/s; peak "
        f"device memory {peak:.2f} GiB; launches {call_launches}")
    del hdp10, res10
    return train_paths, train_pair2, train_sums


def raw_2d_phases(dev, tmp, phase_mark, model, rgs, reference, n_2d=16,
                  ev_min=2000, ev_max=50000, genome_len=400_000):
    """Phases 11a-11c on ``dev`` (the CPU rehearses them at a small size):
    the reads ``run`` and ``train`` take besides basecalled 1D fast5s,
    from the in-memory twins of their fast5s (no h5py on the card's host):
    11a ``rgs`` (phase 4's reads and guides) as raw signal through
    ``align_raw_signal`` and ``align_and_write(..., "both")``, then the
    first N_NOISY_11A of them with noisy samples the same way; 11c the
    embed tables and MEA labels of 11a's results; 11b ``n_2d`` 2D reads
    (a genome of ``genome_len`` bases: past SEEDED_MIN_REF, the guide
    aligner's minimizer index) mapped by ``generate_guide_alignment`` and
    both strands through ``align_2d_and_write``. Returns 11a's, its noisy
    reads' and 11b's launches, by phase and kernel."""
    from signalalign_tpu_torch.io import embed
    from signalalign_tpu_torch.io.minialign import (SEEDED_MIN_REF,
                                                    generate_guide_alignment)
    from signalalign_tpu_torch.ops import banded_fb_hopper as hk
    from signalalign_tpu_torch.pipeline.event_align import (
        align_raw_signal, basecall_event_table, read_from_raw_result)
    from signalalign_tpu_torch.pipeline.runner import (align_2d_and_write,
                                                       align_and_write)
    from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
    from signalalign_tpu_torch.utils.synthetic import (
        build_synthetic_2d_batch, raw_signal_read, synthetic_pore_model,
        twod_read)
    cuda = dev.type == "cuda"

    def reset():
        hk.reset_launch_counts()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def counts():
        return {"sa_fwd_sweep": hk.forward_sweep.launches,
                "sa_bwd_sweep_compact": hk.backward_sweep_compact.launches}

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    def check_strand(reads, results, tag):
        """Every read aligned; pairs in [n/2, 3n]; totals agree."""
        check(len(results) == len(reads),
              f"{tag}: {len(reads) - len(results)} reads failed")
        for read, r in zip(reads, results):
            n = read.n_events
            check(n // 2 <= len(r.aligned_pairs) <= 3 * n,
                  f"{tag} {r.read_label}: {len(r.aligned_pairs)} pairs for "
                  f"{n} events")
            check(r.max_total_gap < 1.0 and np.isfinite(r.total_log_prob),
                  f"{tag} {r.read_label}: total {r.total_log_prob}, "
                  f"total_f - total_b gap {r.max_total_gap}")

    phase_mark("11a")
    # ---- 11a. raw signal: event detection, the adaptive banded
    # alignment, then the main path
    t0 = time.perf_counter()
    signals = [raw_signal_read(read, i) for i, (read, _) in enumerate(rgs)]
    stages = {"fixtures": time.perf_counter() - t0}
    raw_rgs, raw_res = [], []
    drawn = detected = 0
    for (read, guide), signal in zip(rgs, signals):
        res = align_raw_signal(*signal, model, read.template_read,
                               stage_seconds=stages)
        check(res.qc_ok, f"11a {read.read_label}: QC failed ({res.qc_msg})")
        n = len(res.events)
        check(abs(n - read.n_events) <= EVENT_TOL_11A * read.n_events,
              f"11a {read.read_label}: {n} events detected, "
              f"{read.n_events} drawn")
        drawn += read.n_events
        detected += n
        raw_rgs.append((read_from_raw_result(
            res, read.read_label, read.template_read, None,
            model.kmer_length), guide))
        raw_res.append(res)
    del signals
    reset()
    results = []
    t0 = time.perf_counter()
    written = align_and_write(raw_rgs, reference, model,
                              os.path.join(tmp, "out11a"), AlignmentConfig(),
                              output_format="both", device=dev,
                              stage_seconds=stages, results_out=results)
    t_align = time.perf_counter() - t0
    launches_a = counts()
    peak = peak_gib()
    check_strand([r for r, _ in raw_rgs], results, "11a")
    check(not cuda or all(launches_a.values()),
          f"11a: a kernel was not launched: {launches_a}")
    t_raw = stages["detect"] + stages["adaptive_align"]
    log(f"[raw] {len(rgs)} reads, {drawn} events drawn, {detected} "
        f"detected ({detected / drawn:.4f}), every read past QC, "
        f"{sum(len(r.aligned_pairs) for r in results)} pairs, "
        f"{len(written)} files")
    log("[raw] stages " + " ".join(f"{s_}={v:.2f}s"
                                   for s_, v in stages.items()))
    log(f"[raw] detect + adaptive align {t_raw:.2f} s: "
        f"{detected / t_raw:.0f} events/s; align_and_write {t_align:.2f} s; "
        f"end to end {detected / (t_raw + t_align):.0f} events/s; peak "
        f"device memory {peak:.2f} GiB; launches {launches_a}")

    phase_mark("11a noisy")
    # ---- 11a, noisy: the first N_NOISY_11A reads with each sample
    # scattered by its event's stdv. The t-statistic detector splits
    # 8-sample events under such noise (the JAX package's on the same
    # signal, tests/test_torch_raw_signal.py), so these reads are held to
    # QC, pairs and totals, and their detected / drawn ratio is reported
    t0 = time.perf_counter()
    signals = [raw_signal_read(read, i, noise=NOISE_11A)
               for i, (read, _) in enumerate(rgs[:N_NOISY_11A])]
    nstages = {"fixtures": time.perf_counter() - t0}
    noisy_rgs = []
    ndrawn = ndetected = 0
    for (read, guide), signal in zip(rgs, signals):
        res = align_raw_signal(*signal, model, read.template_read,
                               stage_seconds=nstages)
        check(res.qc_ok,
              f"11a noisy {read.read_label}: QC failed ({res.qc_msg})")
        ndrawn += read.n_events
        ndetected += len(res.events)
        noisy_rgs.append((read_from_raw_result(
            res, read.read_label, read.template_read, None,
            model.kmer_length), guide))
    del signals
    reset()
    nresults = []
    t0 = time.perf_counter()
    nwritten = align_and_write(noisy_rgs, reference, model,
                               os.path.join(tmp, "out11a_noisy"),
                               AlignmentConfig(), output_format="both",
                               device=dev, stage_seconds=nstages,
                               results_out=nresults)
    t_nalign = time.perf_counter() - t0
    launches_n = counts()
    check_strand([r for r, _ in noisy_rgs], nresults, "11a noisy")
    check(not cuda or all(launches_n.values()),
          f"11a noisy: a kernel was not launched: {launches_n}")
    t_nraw = nstages["detect"] + nstages["adaptive_align"]
    log(f"[raw noisy] {len(noisy_rgs)} reads at {NOISE_11A} of each "
        f"event's stdv, {ndrawn} events drawn, {ndetected} detected "
        f"({ndetected / ndrawn:.4f}), every read past QC, "
        f"{sum(len(r.aligned_pairs) for r in nresults)} pairs, "
        f"{len(nwritten)} files")
    log("[raw noisy] stages " + " ".join(f"{s_}={v:.2f}s"
                                         for s_, v in nstages.items()))
    log(f"[raw noisy] detect + adaptive align {t_nraw:.2f} s: "
        f"{ndetected / t_nraw:.0f} events/s; align_and_write "
        f"{t_nalign:.2f} s; end to end "
        f"{ndetected / (t_nraw + t_nalign):.0f} events/s; launches "
        f"{launches_n}")
    del noisy_rgs, nresults

    phase_mark("11c")
    # ---- 11c. --embed's tables and MEA labels of 11a's results, in
    # memory (the card's host has no h5py to write them)
    t0 = time.perf_counter()
    n_rows = n_labels = 0
    for res, r in zip(raw_res, results):
        sa = embed.add_raw_fields(embed.full_rows_to_table(r.full_rows(model)),
                                  basecall_event_table(res))
        check(np.array_equal(sa["raw_start"], res.raw_start[sa["event_index"]])
              and (sa["raw_length"] > 0).all(),
              f"11c {r.read_label}: raw coordinates of the rows")
        labels = embed.mea_labels_from_events(sa)
        check(0 < len(labels) <= len(sa)
              and np.all(np.diff(labels["raw_start"]) >= 0)
              and np.all(np.diff(labels["reference_index"]) >= 0),
              f"11c {r.read_label}: {len(labels)} MEA labels of {len(sa)} "
              "rows, not ascending")
        n_rows += len(sa)
        n_labels += len(labels)
    t_embed = time.perf_counter() - t0
    log(f"[embed] {len(results)} reads: {n_rows} full rows with raw "
        f"coordinates, {n_labels} MEA labels in {t_embed:.2f} s")
    del raw_rgs, raw_res, results

    phase_mark("11b")
    # ---- 11b. 2D reads: the guide aligner's seeded path, then both
    # strands, each under its own model
    cmodel = synthetic_pore_model(SEED_COMPLEMENT)
    t0 = time.perf_counter()
    rgs2, comps, ref2, _ = build_synthetic_2d_batch(
        model, cmodel, seed=SEED_2D, n_reads=n_2d, ev_min=ev_min,
        ev_max=ev_max, genome_len=genome_len,
        fasta_path=os.path.join(tmp, "genome11b.fa"))
    reads2d = [twod_read(read, comp) for (read, _), comp in zip(rgs2, comps)]
    stages = {"fixtures": time.perf_counter() - t0}
    check(len(ref2.forward["synth"]) > SEEDED_MIN_REF,
          "11b's genome does not take the seeded guide path")
    t0 = time.perf_counter()
    pairs2d = []
    worst = 0
    for (read, drawn_guide), read2d in zip(rgs2, reads2d):
        g = generate_guide_alignment(read2d.twod_sequence, ref2)
        check(g is not None and g.validate(len(read2d.twod_sequence)),
              f"11b {read.read_label}: no valid guide")
        off = max(abs(g.window_start - drawn_guide.window_start),
                  abs(g.window_end - drawn_guide.window_end))
        check(g.forward == drawn_guide.forward and off <= MAP_TOL_11B,
              f"11b {read.read_label}: mapped to {g.window_start}-"
              f"{g.window_end}, drawn {drawn_guide.window_start}-"
              f"{drawn_guide.window_end}")
        worst = max(worst, off)
        pairs2d.append((read2d, g))
    stages["guide"] = time.perf_counter() - t0
    reset()
    results = []
    t0 = time.perf_counter()
    written = align_2d_and_write(pairs2d, ref2, model, cmodel,
                                 os.path.join(tmp, "out11b"),
                                 AlignmentConfig(), output_format="full",
                                 device=dev, stage_seconds=stages,
                                 results_out=results)
    t_align = time.perf_counter() - t0
    launches_b = counts()
    peak = peak_gib()
    n = len(pairs2d)
    check_strand([r.template for r, _ in pairs2d], results[:n],
                 "11b template")
    check_strand([r.complement for r, _ in pairs2d], results[n:],
                 "11b complement")
    check(all(not r.strand_template for r in results[n:])
          and len(written) == n,
          f"11b: {len(written)} files for {n} reads")
    check(not cuda or all(launches_b.values()),
          f"11b: a kernel was not launched: {launches_b}")
    ev2 = sum(r.template.n_events + r.complement.n_events for r, _ in pairs2d)
    log(f"[2d] {n} reads mapped within {worst} b of their drawn windows; "
        f"{ev2} events (both strands), "
        f"{sum(len(r.aligned_pairs) for r in results)} pairs, "
        f"{len(written)} files")
    log("[2d] stages " + " ".join(f"{s_}={v:.2f}s"
                                  for s_, v in stages.items()))
    log(f"[2d] align_2d_and_write {t_align:.2f} s: {ev2 / t_align:.0f} "
        f"events/s, with the guides {ev2 / (t_align + stages['guide']):.0f} "
        f"events/s; peak device memory {peak:.2f} GiB; launches "
        f"{launches_b}")
    return {"11a": launches_a, "11a_noisy": launches_n, "11b": launches_b}


def level_shifts(build_alignment, hdp, mod="E", base="C"):
    """How far the data and the trained densities put each ``mod`` k-mer
    above the same k-mer with ``base`` in its place, per ``mod`` base, in
    pA, averaged over the pairs observed in both the training table and
    the .nhdp: (rows' mean shift, densities' mean shift, pairs). The drawn
    shift is methylated_pore_model's (3 pA)."""
    sums = {}
    with open(build_alignment) as fh:
        for line in fh:
            kmer, _, value = line.split("\t", 3)[:3]
            e = sums.setdefault(kmer, [0, 0.0])
            e[0] += 1
            e[1] += float(value)
    a = hdp.alphabet
    grid = np.asarray(hdp.grid, dtype=np.float64)

    def dens_mean(kmer):
        d = np.asarray(hdp.densities[a.kmer_index(kmer)], dtype=np.float64)
        return float((grid * d).sum() / d.sum())

    rows, dens = [], []
    for kmer, (n, tot) in sums.items():
        c = kmer.replace(mod, base)
        if mod not in kmer or c not in sums:
            continue
        i, j = a.kmer_index(kmer), a.kmer_index(c)
        if not (hdp.observed[i] and hdp.observed[j]):
            continue
        per = kmer.count(mod)
        rows.append((tot / n - sums[c][1] / sums[c][0]) / per)
        dens.append((dens_mean(kmer) - dens_mean(c)) / per)
    return (float(np.mean(rows)) if rows else float("nan"),
            float(np.mean(dens)) if dens else float("nan"), len(rows))


def check_calls(results, edition, k, codes, bases):
    """Site-mode output checks: every read has calls and no pairs, each
    row's probabilities sum to 1, every call sits on an ambiguity code of
    the edition, |total_f - total_b| < 1 nat, the total is not log 0.
    Returns (site rows, rows
    called ``bases[0]``)."""
    n_rows = n_first = 0
    for r in results:
        vc = r.variant_calls
        check(vc is not None and len(vc) > 0, f"{r.read_label}: no calls")
        check(r.aligned_pairs == [], f"{r.read_label}: pairs in site mode")
        check(r.forward, f"{r.read_label}: reverse-mapped synthetic read")
        check(float(np.abs(vc[bases[0]] + vc[bases[1]] - 1.0).max()) <= 1e-6,
              f"{r.read_label}: {bases[0]} + {bases[1]} != 1")
        # position is the reporting k-mer's start; the site is its last base
        bad = [int(q) for q in vc["position"]
               if edition[int(q) + k - 1] not in codes]
        check(not bad, f"{r.read_label}: calls at positions {bad[:5]} "
              f"without {codes}")
        check(r.max_total_gap < 1.0,
              f"{r.read_label}: total_f - total_b gap {r.max_total_gap}")
        check(r.total_log_prob > -1e29,
              f"{r.read_label}: alignment of probability 0")
        n_rows += len(vc)
        n_first += int((vc[bases[0]] > 0.5).sum())
    return n_rows, n_first


def compare_pairs(a, b, threshold):
    """Max |dp| over shared (x, y, kmer) pairs; fails on pairs that only
    one side has unless they sit within TOL_PATH of the threshold."""
    da = {(x, y, k): p / 1e7 for p, x, y, k in a}
    db = {(x, y, k): p / 1e7 for p, x, y, k in b}
    for key in set(da) ^ set(db):
        p = da.get(key, db.get(key))
        check(abs(p - threshold) <= TOL_PATH, f"pair {key} p={p} on one side only")
    return max((abs(da[k] - db[k]) for k in set(da) & set(db)), default=0.0)


def main():
    t_start = time.perf_counter()

    def phase_mark(name):
        log(f"[time] phase {name} from {time.perf_counter() - t_start:.0f} s")

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    dev = torch.device("cuda")
    log(device_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from signalalign_tpu_torch.convert import hdp_tables, problem_tensors
    from signalalign_tpu_torch.ops import banded_fb as bfb
    from signalalign_tpu_torch.ops import banded_fb_hopper as hk
    from signalalign_tpu_torch.pipeline.runner import (_stack_chunks,
                                                       run_alignment_batch,
                                                       write_outputs)
    from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
    from signalalign_tpu_torch.utils import cuda_build
    from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                       synthetic_pore_model)
    from signalalign_tpu_torch.models.expectations import \
        ExpectationsAccumulator
    from signalalign_tpu_torch.models.pore_model import PoreModel
    from signalalign_tpu_torch.pipeline.train import em_train
    from signalalign_tpu_torch.models.pore_model import ScalingParams
    from signalalign_tpu_torch.pipeline import runner as runner_mod
    from signalalign_tpu_torch.utils.alphabet import DEFAULT_AMBIG_BASES
    from signalalign_tpu_torch.utils.synthetic import (outlier_segments,
                                                       synthetic_read,
                                                       write_genome_fasta)
    from signalalign_tpu_torch.io.reference import ProcessedReference
    from signalalign_tpu_torch.pipeline.runner import prepare_read
    from signalalign_tpu_torch.io.guide import guide_from_sam_record
    from signalalign_tpu_torch.io.reference import AmbiguityPositions
    from signalalign_tpu_torch.io.sam import passes_filter, read_alignment_file
    from signalalign_tpu_torch.pipeline.runner import align_and_write
    from signalalign_tpu_torch.utils.synthetic import write_synthetic_run
    from signalalign_tpu_torch.utils.synthetic import methylated_pore_model
    from signalalign_tpu_torch.models.hdp_model import load_nhdp
    from signalalign_tpu_torch.pipeline.train import (sample_reference,
                                                      train_models)
    check("jax" not in sys.modules and "signalalign_tpu" not in sys.modules,
          "the port imported jax or the JAX package")

    phase_mark("2")
    # ---- 2. build
    b = cuda_build.build()
    log(f"[build] {b.path} in {b.seconds:.1f} s")
    # ptxas' report, each line under its kernel: name<template arguments>
    kernel = ""
    for line in b.log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(sa_[a-z_]+?_kernel|[a-z_]+_probe_kernel)"
                          r"(?:I(\w*?E)E)?", line)
            kernel = (m.group(1) + "<" + ",".join(re.findall(
                r"L[ib](\d+)E", m.group(2) or "")) + ">") if m else ""
        elif "registers" in line or "spill" in line:
            log(f"[build] {kernel}: {line.strip()}")
    cuda_build.load()
    barrier = barrier_latency_us(cuda_build)
    for step, top in (("one", 16), ("two", 32)):
        log(f"[build] one diagonal's synchronisation, {step} barrier(s), a "
            f"block per SM, us at 1, 2, 4, 8, 16{', 32' if top > 16 else ''} "
            "warps: " + ", ".join(f"{barrier[(step, w)]:.4f}" for w in
                                   (1, 2, 4, 8, 16, 32) if w <= top))
    log("[build] one diagonal's synchronisation on a cluster (two cluster "
        "barriers, the warps' maxima in distributed shared memory), a block "
        "per SM, us at C blocks x warps: " + ", ".join(
            f"{C}x{w} {barrier[('cluster', C, w)]:.4f}"
            for C in CLUSTER_SIZES for w in CLUSTER_WARPS))

    with tempfile.TemporaryDirectory() as tmp:
        model = synthetic_pore_model(SEED_MODEL)
        # ambig_frac only routes the reads: the 64 reads are the same, and
        # come with both editions of the genome (phase 4: plain, phase 5:
        # Y at every C of a CG)
        _, reference, rgs, amb_ref, _ = build_synthetic_batch(
            model, n_reads=64, ev_min=2000, ev_max=50000, seed=SEED_READS,
            genome_len=400_000, fasta_path=os.path.join(tmp, "genome.fa"),
            ambig_frac=1.0)
        config = AlignmentConfig()
        threshold = config.threshold
        R = hk.survivor_slots(threshold)

        phase_mark("3a")
        # ---- 3a. kernels against their twins on the card
        p3 = long_p1_problems(rgs, reference, model, config)
        pt = problem_tensors(p3, 256, dev)
        log(f"[kernels] 8 problems W=256 n_diag {min(pt.n_diag)}..{max(pt.n_diag)}"
            f", instance K={hk.cells_per_thread(256, 1)} "
            f"({block_warps(hk, 256, 1)[1]} warps)")
        p1 = kernels_vs_twins(hk, bfb, pt, threshold, R)
        p1_bounds = sweep_bounds(bfb, pt, p1["n_kernel"])
        p1_floor = serial_floor_ms(hk, barrier, pt)
        log(f"[kernels] sa_fwd_sweep {p1['fwd_ms']:.3f} ms, twin "
            f"{p1['fwd_plain_ms']:.1f} ms; |d total_f| {p1['tf_err']:.3e} nats "
            f"(tol {TOL_TOTAL}), |d exp(fstack)| {p1['fdiff']:.3e} (tol {TOL_POST})")
        log(f"[kernels] sa_bwd_sweep_compact {p1['bwd_ms']:.3f} ms, twin "
            f"{p1['bwd_plain_ms']:.1f} ms; |d total_b| {p1['tb_err']:.3e} nats, "
            f"survivors {p1['n_kernel']} vs {p1['n_twin']}, |d posterior| "
            f"{p1['pdiff']:.3e} (tol {TOL_POST})")
        log("[kernels] bounds " + ", ".join(
            f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in p1_bounds.items())
            + f"; serial-diagonal floor {p1_floor:.3f} ms")

        phase_mark("3b")
        # ---- 3b. the main path on the GPU against the CPU (twins)
        small = sorted(rgs, key=lambda rg: rg[0].events.shape[0])[:1]
        on_cpu = run_alignment_batch(small, reference, model, config,
                                     device=torch.device("cpu"))
        on_gpu = run_alignment_batch(small, reference, model, config, device=dev)
        check(len(on_cpu) == len(on_gpu) == 1, "small batch lost a read")
        worst = 0.0
        for a, g in zip(on_cpu, on_gpu):
            check(abs(a.total_log_prob - g.total_log_prob) <= TOL_TOTAL,
                  f"{a.read_label}: total {g.total_log_prob} vs cpu {a.total_log_prob}")
            worst = max(worst, compare_pairs(a.aligned_pairs, g.aligned_pairs,
                                             threshold))
        check(worst <= TOL_PATH, f"pair posteriors differ by {worst}")
        log(f"[small] {[r.events.shape[0] for r, _ in small]} events: gpu = cpu "
            f"within {TOL_TOTAL} nats, |d p| {worst:.3e} (tol {TOL_PATH})")

        phase_mark("3d")
        # ---- 3d. site calls and P > 1 pairs on the GPU against the CPU
        amb_cfg = AlignmentConfig(ambig_map=AMB).for_batch(len(rgs))
        small = sorted(rgs, key=lambda rg: rg[0].events.shape[0])[:1]
        worst_calls = worst_pairs = 0.0
        for kw in ({"call_variants": "CT"}, {}):
            on_cpu = run_alignment_batch(small, amb_ref, model, amb_cfg,
                                         device=torch.device("cpu"), **kw)
            on_gpu = run_alignment_batch(small, amb_ref, model, amb_cfg,
                                         device=dev, **kw)
            check(len(on_cpu) == len(on_gpu) == 1, "small site batch lost a read")
            for a, g in zip(on_cpu, on_gpu):
                check(abs(a.total_log_prob - g.total_log_prob) <= TOL_TOTAL,
                      f"{a.read_label}: total {g.total_log_prob} vs cpu "
                      f"{a.total_log_prob}")
                if kw:
                    check(len(g.variant_calls) > 0, f"{g.read_label}: no calls")
                    worst_calls = max(worst_calls, compare_calls(
                        a.variant_calls, g.variant_calls))
                else:
                    worst_pairs = max(worst_pairs, compare_pairs(
                        a.aligned_pairs, g.aligned_pairs, threshold))
        check(worst_calls <= TOL_PATH and worst_pairs <= TOL_PATH,
              f"site calls differ by {worst_calls}, P>1 pairs by {worst_pairs}")
        log(f"[small sites] {[r.events.shape[0] for r, _ in small]} events: "
            f"gpu = cpu, |d p_C| {worst_calls:.3e}, P>1 pairs |d p| "
            f"{worst_pairs:.3e} (tol {TOL_PATH})")

        phase_mark("4")
        # ---- 4. the main path at a realistic size
        hk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        mem4 = torch.cuda.memory_allocated()
        stages = {}
        t0 = time.perf_counter()
        with Recorder(runner_mod) as rec4:
            results = run_alignment_batch(rgs, reference, model, config,
                                          device=dev, stage_seconds=stages)
        t_align = time.perf_counter() - t0
        launches = {"sa_fwd_sweep": hk.forward_sweep.launches,
                    "sa_bwd_sweep_compact": hk.backward_sweep_compact.launches}
        peak = torch.cuda.max_memory_allocated()
        out_dir = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        written = write_outputs(results, model, out_dir, "both")
        t_write = time.perf_counter() - t0

        check(len(results) == len(rgs), f"{len(rgs) - len(results)} reads failed")
        n_events = 0
        genome = reference.forward["synth"]
        k = model.kmer_length
        for (read, _), r in zip(rgs, results):
            n = read.n_events
            n_events += n
            # pairs are match cells: each k-mer reports about one, and these
            # reads carry ~1.39 events per k-mer (a stay is a gapY event and
            # reports none), so the upstream n <= pairs <= 3n, made for
            # noisier real reads, holds here from n/2
            check(n // 2 <= len(r.aligned_pairs) <= 3 * n,
                  f"{r.read_label}: {len(r.aligned_pairs)} pairs for {n} events")
            check(r.max_total_gap < 1.0,
                  f"{r.read_label}: total_f - total_b gap {r.max_total_gap}")
            check(np.isfinite(r.total_log_prob), f"{r.read_label}: total not finite")
        n_rows = 0
        for path in written:
            if not path.endswith((".forward.tsv", ".backward.tsv")):
                continue
            with open(path) as fh:
                for line in fh:
                    col = line.split("\t")
                    ri = int(col[1])
                    check(genome[ri:ri + k] == col[2],
                          f"{os.path.basename(path)}: k-mer {col[2]} at {ri}")
                    n_rows += 1
        check(all(launches.values()), f"a kernel was not launched: {launches}")
        n_pairs = sum(len(r.aligned_pairs) for r in results)
        log(f"[main] {len(results)} reads, {n_events} events, {n_pairs} pairs, "
            f"{n_rows} full rows checked, {len(written)} files")
        log("[main] stages " + " ".join(f"{s}={v:.2f}s" for s, v in stages.items())
            + f" write={t_write:.2f}s")
        log(f"[main] run_alignment_batch {t_align:.2f} s: "
            f"{n_events / t_align:.0f} events/s; kernels stage "
            f"{n_events / stages['kernels']:.0f} events/s; "
            f"peak device memory {peak / 2**30:.2f} GiB (allocated at the "
            f"start {mem4 / 2**30:.2f} GiB)")
        log(f"[main] launches {launches}")
        main_results, t_main, main_stages = results, t_align, stages
        main_written = written

        phase_mark("5")
        # ---- 5. site-mode methylation calling at a realistic size
        hk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        t0 = time.perf_counter()
        with Recorder(runner_mod) as rec5:
            results = run_alignment_batch(rgs, amb_ref, model, amb_cfg,
                                          device=dev, call_variants="CT",
                                          stage_seconds=stages)
        t_sites = time.perf_counter() - t0
        site_launches = {"sa_fwd_sweep": hk.forward_sweep.launches,
                         "sa_bwd_sweep_compact": hk.backward_sweep_compact.launches}
        peak = torch.cuda.max_memory_allocated()
        out_dir = os.path.join(tmp, "variants")
        t0 = time.perf_counter()
        written = write_outputs(results, model, out_dir, "variants",
                                variants="CT")
        t_write = time.perf_counter() - t0

        check(len(results) == len(rgs), f"{len(rgs) - len(results)} reads failed")
        n_rows, n_c = check_calls(results, amb_ref.forward["synth"], k, "Y",
                                  "CT")
        names = [os.path.basename(w) for w in written]
        for name in ("variants_aggregate.tsv", "variants_per_read.tsv"):
            check(name in names and os.path.getsize(
                os.path.join(out_dir, name)) > 0, f"{name} missing or empty")
        check(len(names) == len(rgs) + 2, f"{len(names)} variants files")
        share_c = n_c / n_rows
        check(share_c >= MIN_SHARE_C,
              f"share of sites called C {share_c:.3f} < {MIN_SHARE_C}")
        check(all(site_launches.values()),
              f"a kernel was not launched in site mode: {site_launches}")
        # the segments run_alignment_batch ran (site mode skips P = 1 ones:
        # this edition has none)
        wp = {k: len(v) for k, v in rec5.classes().items()}
        n_seg = sum(wp.values())
        log(f"[sites] {len(results)} reads, {n_events} events, {n_rows} site "
            f"rows, share called C {share_c:.4f} (bound {MIN_SHARE_C}), "
            f"{len(written)} files")
        log("[sites] segments by (W, P): " + " ".join(
            f"{w},{p}:{n}" for (w, p), n in sorted(wp.items()))
            + f" ({n_seg} segments; P=8 share "
            f"{sum(n for (w, p), n in wp.items() if p == 8) / n_seg:.3f})")
        log("[sites] stages " + " ".join(f"{s_}={v:.2f}s" for s_, v in stages.items())
            + f" write={t_write:.2f}s")
        log(f"[sites] run_alignment_batch {t_sites:.2f} s: "
            f"{n_events / t_sites:.0f} events/s; kernels stage "
            f"{n_events / stages['kernels']:.0f} events/s; "
            f"peak device memory {peak / 2**30:.2f} GiB")
        log(f"[sites] launches {site_launches}")
        sites_written = written

        phase_mark("3c")
        # ---- 3c. P > 1 kernels against their twins on the card, on the
        # shapes phase 5 gave them: one bucket per (W, P) class of its
        # aligners, the class's shortest problem
        by_class = rec5.classes()
        paths_rows, paths_bounds = {}, {}
        # the problems phase 10a runs the expectation pass of the P > 2
        # instances on: the W = 256 classes of P = 2, 4 and 8, the wide P =
        # 1 segments and the wide instance's two segments
        exp10_sets = {}
        for (W, P), probs in sorted(by_class.items()):
            if P == 1:
                continue    # site mode skips P = 1 segments
            probs = probs[:1]
            if W == 256 and P in (2, 4, 8):
                exp10_sets[(W, P)] = probs
            ptp = problem_tensors(probs, W, dev)
            r = kernels_vs_twins(hk, bfb, ptp, threshold, R)
            paths_rows[(W, P)] = r
            paths_bounds[(W, P)] = bd = sweep_bounds(bfb, ptp, r["n_kernel"])
            log(f"[kernels P={P} W={W} K={hk.cells_per_thread(W, P)}] "
                f"{len(probs)} problems n_diag {min(ptp.n_diag)}..{max(ptp.n_diag)}: "
                f"sa_fwd_sweep {r['fwd_ms']:.3f} ms (twin {r['fwd_plain_ms']:.1f} ms, "
                f"bound {bd['sa_fwd_sweep'][0]:.4f} ms by "
                f"{bd['sa_fwd_sweep'][1]}), "
                f"sa_bwd_sweep_compact {r['bwd_ms']:.3f} ms (twin "
                f"{r['bwd_plain_ms']:.1f} ms, bound "
                f"{bd['sa_bwd_sweep_compact'][0]:.4f} ms by "
                f"{bd['sa_bwd_sweep_compact'][1]}), serial floor "
                f"{serial_floor_ms(hk, barrier, ptp):.3f} ms; |d total| "
                f"{max(r['tf_err'], r['tb_err']):.3e} nats, |d exp(fstack)| "
                f"{r['fdiff']:.3e}, |d posterior| {r['pdiff']:.3e}, survivors "
                f"{r['n_kernel']} vs {r['n_twin']} on paths {r['paths']}; "
                f"bit for bit {r['bit_equal']}")
        ks = {-hk.cells_per_thread(W, P) for W, P in paths_rows
              if hk.cells_per_thread(W, P) < 0}
        check(ks == {1, 2, 4, 8}, f"phase 5's buckets hold the P > 2 "
              f"instances of cells per thread {sorted(ks)}, not every one of "
              "1, 2, 4, 8")
        # a P = 16 segment: two X (ACGT) sites in one k-mer of the
        # shortest read's window, held bit for bit like the classes above;
        # then that read through run_alignment_batch, on the GPU and CPU
        small = sorted(rgs, key=lambda rg: rg[0].events.shape[0])[:1]
        g16 = small[0][1]
        site = (g16.window_start + g16.window_end) // 2
        plain = reference.forward["synth"]
        fa16 = os.path.join(tmp, "x16.fa")
        write_genome_fasta(plain[:site] + "XX" + plain[site + 2:], fa16)
        ref16 = ProcessedReference(fa16)
        segs16 = [(W, q) for _, q, W, _, P in prepare_read(
            *small[0], ref16, model, config)[4] if P == 16]
        check(len(segs16) >= 1, "no P = 16 segment in the X-edited read")
        W16 = segs16[0][0]
        pt16 = problem_tensors([segs16[0][1]], W16, dev)
        r = kernels_vs_twins(hk, bfb, pt16, threshold, R)
        check(r["bit_equal"], "the P = 16 kernels differ from their twins")
        paths_rows[(W16, 16)] = r
        paths_bounds[(W16, 16)] = bd = sweep_bounds(bfb, pt16, r["n_kernel"])
        on_cpu = run_alignment_batch(small, ref16, model, config,
                                     device=torch.device("cpu"))
        on_gpu = run_alignment_batch(small, ref16, model, config, device=dev)
        check(len(on_cpu) == len(on_gpu) == 1, "the P = 16 read was dropped")
        d16 = abs(on_cpu[0].total_log_prob - on_gpu[0].total_log_prob)
        w16 = compare_pairs(on_cpu[0].aligned_pairs, on_gpu[0].aligned_pairs,
                            threshold)
        check(d16 <= TOL_TOTAL and w16 <= TOL_PATH,
              f"the P = 16 read: totals {d16}, pairs {w16}")
        log(f"[kernels P=16 W={W16} K={hk.cells_per_thread(W16, 16)}] 1 "
            f"problem n_diag {pt16.n_diag[0]} (two X sites in one k-mer): "
            f"sa_fwd_sweep {r['fwd_ms']:.3f} ms (twin {r['fwd_plain_ms']:.1f}"
            f" ms, bound {bd['sa_fwd_sweep'][0]:.4f} ms), sa_bwd_sweep_compact "
            f"{r['bwd_ms']:.3f} ms (twin {r['bwd_plain_ms']:.1f} ms, bound "
            f"{bd['sa_bwd_sweep_compact'][0]:.4f} ms), serial floor "
            f"{serial_floor_ms(hk, barrier, pt16):.3f} ms; bit for bit "
            f"{r['bit_equal']}, survivors {r['n_kernel']} on paths "
            f"{r['paths']}; the read through run_alignment_batch: gpu = cpu, "
            f"|d total| {d16:.3e} nats, |d p| {w16:.3e} (tol {TOL_PATH}), "
            f"{len(on_gpu[0].aligned_pairs)} pairs")
        del pt16, segs16, ref16
        # two P = 1 segments too wide for the per-pair instances: the P > 2
        # instances at P = 1, held bit for bit like the classes above
        exp10_sets[(WIDE_P1_W, 1)] = wide_p1_problems(
            bfb, model, ScalingParams, DEFAULT_AMBIG_BASES)
        ptw = problem_tensors(exp10_sets[(WIDE_P1_W, 1)], WIDE_P1_W, dev)
        bw = int(ptw.width.max())
        kw_ = hk.cells_per_thread(WIDE_P1_W, 1)
        check(bw > 2048 and kw_ < 0, f"the wide P = 1 segments: band {bw} "
              f"offsets, cells per thread {kw_}")
        r = kernels_vs_twins(hk, bfb, ptw, threshold, R)
        check(r["bit_equal"], f"the P = 1 W = {WIDE_P1_W} kernels differ "
              "from their twins")
        paths_rows[(WIDE_P1_W, 1)] = r
        paths_bounds[(WIDE_P1_W, 1)] = bd = sweep_bounds(bfb, ptw,
                                                         r["n_kernel"])
        log(f"[kernels P=1 W={WIDE_P1_W} K={kw_}] 2 problems n_diag "
            f"{min(ptw.n_diag)}..{max(ptw.n_diag)}, band {bw} offsets: "
            f"sa_fwd_sweep {r['fwd_ms']:.3f} ms (twin {r['fwd_plain_ms']:.1f}"
            f" ms, bound {bd['sa_fwd_sweep'][0]:.4f} ms), sa_bwd_sweep_compact "
            f"{r['bwd_ms']:.3f} ms (twin {r['bwd_plain_ms']:.1f} ms, bound "
            f"{bd['sa_bwd_sweep_compact'][0]:.4f} ms), serial floor "
            f"{serial_floor_ms(hk, barrier, ptw):.3f} ms; bit for bit "
            f"{r['bit_equal']}, survivors {r['n_kernel']} vs {r['n_twin']}")
        del ptw
        # past 8,192 cells a diagonal, the wide instance: a P = 64 segment
        # (three X sites in one k-mer) and a P = 16 one at W = 768, held
        # bit for bit like the classes above; then the P = 64 read through
        # run_alignment_batch, its launches counted from 0, on the GPU and
        # the CPU
        rg64, ref64 = x_read(model, reference.forward["synth"], tmp, 3)
        segs64 = [(W, q) for _, q, W, _, P in prepare_read(
            *rg64, ref64, model, config)[4] if P == 64]
        check(len(segs64) == 1, f"{len(segs64)} P = 64 segments in the x64 read")
        segs64_w = segs64[0][0]
        wide_rows, wide_bounds = {}, {}
        for (W_, P_), probs in (((segs64_w, 64), [segs64[0][1]]),
                                ((768, 16), wide_p16_problems(
                                    bfb, model, ScalingParams,
                                    DEFAULT_AMBIG_BASES))):
            exp10_sets[(W_, P_)] = probs
            ptw = problem_tensors(probs, W_, dev)
            kw_ = hk.cells_per_thread(W_, P_)
            bw = int(ptw.width.max())
            cl_ = [(hk.cluster_ctas(W_, P_, False, b_),
                    hk.cluster_threads(W_, P_, False, b_)) for b_ in (0, 1)]
            check(kw_ < -8 and (P_ == 64 or bw > 512)
                  and all(c_ for c_, _ in cl_),
                  f"the P = {P_} W = {W_} segment: band {bw} offsets, "
                  f"cells per thread {kw_}, cluster (blocks, threads) "
                  f"{cl_}: not the cluster instance's shape")
            r = kernels_vs_twins(hk, bfb, ptw, threshold, R)
            check(r["bit_equal"], f"the wide instance (P = {P_}, W = {W_}) "
                  "differs from its twins")
            paths_rows[(W_, P_)] = wide_rows[(W_, P_)] = r
            paths_bounds[(W_, P_)] = wide_bounds[(W_, P_)] = bd = \
                sweep_bounds(bfb, ptw, r["n_kernel"])
            nd_ = max(ptw.n_diag)
            r["floor"] = serial_floor_ms(hk, barrier, ptw)
            log(f"[kernels P={P_} W={W_} K={kw_} (wide, cluster of "
                f"{cl_[0][0]} x {cl_[0][1]} / {cl_[1][0]} x {cl_[1][1]})] 1 "
                f"problem n_diag "
                f"{nd_}, band {bw} offsets: sa_fwd_sweep {r['fwd_ms']:.3f} ms "
                f"({1e3 * r['fwd_ms'] / nd_:.2f} us a diagonal; twin "
                f"{r['fwd_plain_ms']:.1f} ms, bound "
                f"{bd['sa_fwd_sweep'][0]:.4f} ms), sa_bwd_sweep_compact "
                f"{r['bwd_ms']:.3f} ms ({1e3 * r['bwd_ms'] / nd_:.2f} us a "
                f"diagonal; twin {r['bwd_plain_ms']:.1f} ms, bound "
                f"{bd['sa_bwd_sweep_compact'][0]:.4f} ms), serial floor "
                f"{r['floor']:.3f} ms; bit for bit {r['bit_equal']}, "
                f"survivors {r['n_kernel']} on {len(r['paths'])} paths")
            del ptw
        hk.reset_launch_counts()
        on_gpu = run_alignment_batch([rg64], ref64, model, config, device=dev)
        wide_launches = {"sa_fwd_sweep": hk.forward_sweep.cluster_launches,
                         "sa_bwd_sweep_compact":
                             hk.backward_sweep_compact.cluster_launches}
        check(all(v >= 1 for v in wide_launches.values()),
              f"the P = 64 read ran no cluster instance: {wide_launches}")
        on_cpu = run_alignment_batch([rg64], ref64, model, config,
                                     device=torch.device("cpu"))
        check(len(on_cpu) == len(on_gpu) == 1, "the P = 64 read was dropped")
        d64 = abs(on_cpu[0].total_log_prob - on_gpu[0].total_log_prob)
        w64 = compare_pairs(on_cpu[0].aligned_pairs, on_gpu[0].aligned_pairs,
                            threshold)
        n64 = rg64[0].n_events
        check(d64 <= TOL_TOTAL and w64 <= TOL_PATH
              and n64 // 2 <= len(on_gpu[0].aligned_pairs) <= 3 * n64
              and not any("X" in r[3] for r in on_gpu[0].aligned_pairs),
              f"the P = 64 read: totals {d64}, pairs {w64}, "
              f"{len(on_gpu[0].aligned_pairs)} pairs of {n64} events")
        log(f"[x64] the P = 64 read ({n64} events) through "
            f"run_alignment_batch: cluster launches {wide_launches}; gpu = "
            f"cpu, |d total| {d64:.3e} nats, |d p| {w64:.3e} (tol "
            f"{TOL_PATH}), {len(on_gpu[0].aligned_pairs)} pairs")
        del segs64, ref64
        # past the cluster instance's CAP, the scratch instance: a short P
        # = 64 problem at W = 1024, and a read with four X sites in one
        # k-mer (P = 256 at W = 256) through run_alignment_batch on the
        # GPU, its launches counted from 0 (its CPU run would take the
        # twins minutes), and its one segment; both held bit for bit like
        # the classes above
        scratch_rows, scratch_bounds = {}, {}

        def past_cap(ptw, what):
            W_, P_ = ptw.W, ptw.P
            kw_ = hk.cells_per_thread(W_, P_)
            check(kw_ < -8 and not any(hk.cluster_ctas(W_, P_, e_, b_)
                                       for e_ in (0, 1) for b_ in (0, 1)),
                  f"the P = {P_} W = {W_} {what}: cells per thread {kw_}, "
                  "not past the cluster instance's CAP")
            r = kernels_vs_twins(hk, bfb, ptw, threshold, R)
            check(r["bit_equal"], f"the scratch instance (P = {P_}, W = "
                  f"{W_}) differs from its twins")
            scratch_rows[(W_, P_)] = r
            scratch_bounds[(W_, P_)] = bd = sweep_bounds(bfb, ptw,
                                                         r["n_kernel"])
            nd_ = max(ptw.n_diag)
            r["floor"] = serial_floor_ms(hk, barrier, ptw)
            log(f"[kernels P={P_} W={W_} K={kw_} (wide, scratch: past CAP)] "
                f"1 {what} n_diag {nd_}: sa_fwd_sweep {r['fwd_ms']:.3f} ms "
                f"({1e3 * r['fwd_ms'] / nd_:.2f} us a diagonal; twin "
                f"{r['fwd_plain_ms']:.1f} ms, bound "
                f"{bd['sa_fwd_sweep'][0]:.4f} ms), sa_bwd_sweep_compact "
                f"{r['bwd_ms']:.3f} ms ({1e3 * r['bwd_ms'] / nd_:.2f} us a "
                f"diagonal; twin {r['bwd_plain_ms']:.1f} ms, bound "
                f"{bd['sa_bwd_sweep_compact'][0]:.4f} ms), serial floor "
                f"{r['floor']:.3f} ms; bit for bit {r['bit_equal']}, "
                f"survivors {r['n_kernel']}")

        ptw = problem_tensors(pastcap_problems(
            bfb, model, ScalingParams, DEFAULT_AMBIG_BASES), 1024, dev)
        past_cap(ptw, "problem")
        del ptw
        rg256, ref256 = x_read(model, reference.forward["synth"], tmp, 4,
                               SEED_PASTCAP)
        hk.reset_launch_counts()
        on_gpu = run_alignment_batch([rg256], ref256, model, config,
                                     device=dev)
        scratch_launches = {
            "sa_fwd_sweep": hk.forward_sweep.wide_scratch_launches,
            "sa_bwd_sweep_compact":
                hk.backward_sweep_compact.wide_scratch_launches}
        n256 = rg256[0].n_events
        check(all(v >= 1 for v in scratch_launches.values())
              and len(on_gpu) == 1
              and abs(on_gpu[0].total_log_prob) < 1e29
              and n256 // 2 <= len(on_gpu[0].aligned_pairs) <= 3 * n256
              and not any("X" in r_[3] for r_ in on_gpu[0].aligned_pairs),
              f"the P = 256 read: scratch launches {scratch_launches}, "
              f"{len(on_gpu)} results")
        log(f"[x256] the P = 256 read ({n256} events) through "
            f"run_alignment_batch on the GPU: scratch launches "
            f"{scratch_launches}, total {on_gpu[0].total_log_prob:.2f}, "
            f"{len(on_gpu[0].aligned_pairs)} pairs")
        segs256 = [(W, q) for _, q, W, _, P in prepare_read(
            *rg256, ref256, model, config)[4] if P == 256]
        check(len(segs256) == 1,
              f"{len(segs256)} P = 256 segments in the x256 read")
        scratch_wp = (segs256[0][0], 256)
        ptw = problem_tensors([segs256[0][1]], segs256[0][0], dev)
        past_cap(ptw, "segment (the read's)")
        del ptw, segs256, ref256
        check(sum(min(2, len(v)) for (_, P), v in by_class.items() if P == 8)
              >= 2, "fewer than two P=8 problems")

        phase_mark("5b")
        # ---- 5b. kernel time of each phase-5 chunk, by CUDA events;
        # summed by (W, P)
        log_kernel_sums("sites", chunk_sums(
            hk, bfb, problem_tensors, rec5.chunks(), dev, threshold, R),
            t_sites)
        del by_class, rec5

        phase_mark("6")
        # ---- 6. HDP methylation calling (the flagship workload)
        t0 = time.perf_counter()
        model6, hdp6, rgs6, plain6, ref6, cfg6 = hdp_batch(tmp)
        table_bytes = 2 * hdp6.densities.size * 4
        log(f"[hdp] model {model6.alphabet.letters} k={model6.kmer_length} "
            f"({model6.num_kmers} k-mers), HDP grid {hdp6.grid[0]:.0f}-"
            f"{hdp6.grid[-1]:.0f} pA x {len(hdp6.grid)}, tables "
            f"{table_bytes / 2**20:.1f} MiB, made with the reads in "
            f"{time.perf_counter() - t0:.1f} s")
        n_events6 = sum(r.n_events for r, _ in rgs6)

        phase_mark("6b")
        # ---- 6b. HDP calls and pairs on the GPU against the CPU (twins)
        small6 = sorted(rgs6, key=lambda rg: rg[0].events.shape[0])[:1]
        worst_calls = worst_pairs = 0.0
        for kw in ({"call_variants": "CE"}, {}):
            on_cpu = run_alignment_batch(small6, ref6, model6, cfg6, hdp6,
                                         device=torch.device("cpu"), **kw)
            on_gpu = run_alignment_batch(small6, ref6, model6, cfg6, hdp6,
                                         device=dev, **kw)
            check(len(on_cpu) == len(on_gpu) == 1, "small HDP batch lost a read")
            for a, g in zip(on_cpu, on_gpu):
                check(abs(a.total_log_prob - g.total_log_prob) <= TOL_TOTAL,
                      f"{a.read_label}: HDP total {g.total_log_prob} vs cpu "
                      f"{a.total_log_prob}")
                if kw:
                    check(len(g.variant_calls) > 0, f"{g.read_label}: no calls")
                    worst_calls = max(worst_calls, compare_calls(
                        a.variant_calls, g.variant_calls))
                else:
                    check(len(g.aligned_pairs) > 0, f"{g.read_label}: no pairs")
                    worst_pairs = max(worst_pairs, compare_pairs(
                        a.aligned_pairs, g.aligned_pairs, threshold))
        check(worst_calls <= TOL_PATH and worst_pairs <= TOL_PATH,
              f"HDP calls differ by {worst_calls}, pairs by {worst_pairs}")
        log(f"[small hdp] {[r.events.shape[0] for r, _ in small6]} events: "
            f"gpu = cpu, |d p_C| {worst_calls:.3e}, pairs |d p| "
            f"{worst_pairs:.3e} (tol {TOL_PATH})")

        phase_mark("6c")
        # ---- 6c. HDP methylation calling at a realistic size
        hk.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        t0 = time.perf_counter()
        with Recorder(runner_mod) as rec6:
            results = run_alignment_batch(rgs6, ref6, model6, cfg6, hdp6,
                                          device=dev, call_variants="CE",
                                          stage_seconds=stages)
        t_hdp = time.perf_counter() - t0
        hdp_launches = {"sa_fwd_sweep": hk.forward_sweep.launches,
                        "sa_bwd_sweep_compact": hk.backward_sweep_compact.launches}
        peak = torch.cuda.max_memory_allocated()
        out_dir = os.path.join(tmp, "variants_hdp")
        t0 = time.perf_counter()
        written = write_outputs(results, model6, out_dir, "variants",
                                variants="CE")
        t_write = time.perf_counter() - t0
        check(len(results) == len(rgs6), f"{len(rgs6) - len(results)} reads failed")
        n_rows, n_c = check_calls(results, ref6.forward["synth"],
                                  model6.kmer_length, "P", "CE")
        names = [os.path.basename(w) for w in written]
        for name in ("variants_aggregate.tsv", "variants_per_read.tsv"):
            check(name in names and os.path.getsize(
                os.path.join(out_dir, name)) > 0, f"{name} missing or empty")
        check(len(names) == len(rgs6) + 2, f"{len(names)} variants files")
        share_c = n_c / n_rows
        check(share_c >= MIN_SHARE_C_HDP,
              f"HDP share of sites called C {share_c:.3f} < {MIN_SHARE_C_HDP}")
        check(all(hdp_launches.values()),
              f"a kernel was not launched in HDP mode: {hdp_launches}")
        wp6 = {k: len(v) for k, v in rec6.classes().items()}
        log(f"[hdp] {len(results)} reads, {n_events6} events, {n_rows} site "
            f"rows, share called C {share_c:.4f} (bound {MIN_SHARE_C_HDP}), "
            f"{len(written)} files")
        log("[hdp] segments by (W, P): " + " ".join(
            f"{w},{p}:{n}" for (w, p), n in sorted(wp6.items()))
            + f" ({sum(wp6.values())} segments in {len(rec6.buckets())} "
            "buckets)")
        log("[hdp] stages " + " ".join(f"{s_}={v:.2f}s" for s_, v in stages.items())
            + f" write={t_write:.2f}s")
        log(f"[hdp] table upload {table_bytes / 2**20:.1f} MiB in "
            f"{stages['hdp_upload']:.3f} s, once per run_alignment_batch")
        log(f"[hdp] run_alignment_batch {t_hdp:.2f} s: "
            f"{n_events6 / t_hdp:.0f} events/s; kernels stage "
            f"{n_events6 / stages['kernels']:.0f} events/s; "
            f"peak device memory {peak / 2**30:.2f} GiB")
        log(f"[hdp] launches {hdp_launches}")

        phase_mark("6a")
        # ---- 6a. HDP kernels against their twins, one bucket per (W, P)
        # class of 6c's aligners, the class's shortest problem
        by_class6 = rec6.classes()
        tables = hdp_tables(*hdp6.density_arrays(), dev)
        hdp_rows, hdp_bounds = {}, {}
        for (W, P), probs in sorted(by_class6.items()):
            probs = probs[:1]
            pth = problem_tensors(probs, W, dev, tables)
            r = kernels_vs_twins(hk, bfb, pth, threshold, R)
            hdp_rows[(W, P)] = r
            hdp_bounds[(W, P)] = bd = sweep_bounds(bfb, pth, r["n_kernel"])
            floor = serial_floor_ms(hk, barrier, pth)
            log(f"[hdp kernels P={P} W={W} K={hk.cells_per_thread(W, P)}] "
                f"{len(probs)} problems n_diag {min(pth.n_diag)}..{max(pth.n_diag)}: "
                f"sa_fwd_sweep {r['fwd_ms']:.3f} ms (twin {r['fwd_plain_ms']:.1f} ms, "
                f"bound {bd['sa_fwd_sweep'][0]:.4f} ms by "
                f"{bd['sa_fwd_sweep'][1]}), "
                f"sa_bwd_sweep_compact {r['bwd_ms']:.3f} ms (twin "
                f"{r['bwd_plain_ms']:.1f} ms, bound "
                f"{bd['sa_bwd_sweep_compact'][0]:.4f} ms by "
                f"{bd['sa_bwd_sweep_compact'][1]}), "
                f"serial floor {floor:.3f} ms; |d total| "
                f"{max(r['tf_err'], r['tb_err']):.3e} nats, |d exp(fstack)| "
                f"{r['fdiff']:.3e}, |d posterior| {r['pdiff']:.3e}, survivors "
                f"{r['n_kernel']} vs {r['n_twin']} on paths {r['paths']}; "
                f"bit for bit {r['bit_equal']}")
        ks6 = sorted({hk.cells_per_thread(W, P) for W, P in hdp_rows})
        log(f"[hdp kernels] instances held here K={ks6} (negative: P > 2); "
            "tests/test_torch_kernels_cuda.py holds HDP at K=1, 2, 4, 8")
        del tables, pth    # pth.hdp holds the tables too

        phase_mark("6d")
        # ---- 6d. kernel time of each phase-6 chunk, by CUDA events
        log_kernel_sums("hdp", chunk_sums(
            hk, bfb, problem_tensors, rec6.chunks(), dev, threshold, R,
            hdp_tables(*hdp6.density_arrays(), dev)), t_hdp)
        del by_class6, rec6

        phase_mark("7")
        # ---- 7. EM training: the expectation instances (P = 1)
        em_cfg = dataclasses.replace(
            config, compute_expectations=True,
            max_segment_diagonals=EM_SEGMENT_DIAGONALS).for_batch(len(rgs))
        rgs7d = rgs6[:16]

        phase_mark("7b")
        # ---- 7b. the expectation pass on the GPU against the CPU (twins)
        small = sorted(rgs, key=lambda rg: rg[0].events.shape[0])[:1]
        on_cpu = run_alignment_batch(small, reference, model, em_cfg,
                                     device=torch.device("cpu"))
        on_gpu = run_alignment_batch(small, reference, model, em_cfg,
                                     device=dev)
        check(len(on_cpu) == len(on_gpu) == 1, "small EM batch lost a read")
        worst_t = worst_k = 0.0
        for a, g in zip(on_cpu, on_gpu):
            check(abs(a.total_log_prob - g.total_log_prob) <= TOL_TOTAL,
                  f"{a.read_label}: EM total {g.total_log_prob} vs cpu "
                  f"{a.total_log_prob}")
            for name, ga, ca, tol in (
                    ("texp", g.transition_expectations,
                     a.transition_expectations, TEXP_TOL),
                    ("kexp", g.emission_expectations,
                     a.emission_expectations, KEXP_TOL)):
                bad = np.abs(ga - ca) > tol["atol"] + tol["rtol"] * np.abs(ca)
                check(not bad.any(), f"{a.read_label}: {name} gpu vs cpu "
                      f"{np.abs(ga - ca).max()}")
            worst_t = max(worst_t, float(np.abs(
                g.transition_expectations - a.transition_expectations).max()))
            worst_k = max(worst_k, float(np.abs(
                g.emission_expectations - a.emission_expectations).max()))
        log(f"[small em] {[r.events.shape[0] for r, _ in small]} events: gpu "
            f"= cpu, |d texp| {worst_t:.3e}, |d kexp| {worst_k:.3e} (rtol "
            f"{TEXP_TOL['rtol']} / {KEXP_TOL['rtol']}, atol {TEXP_TOL['atol']})")

        phase_mark("7c")
        # ---- 7c. em_train at full width on the 64 reads of phase 4
        start = synthetic_pore_model(SEED_MODEL)
        start.level_mean = start.level_mean + np.random.default_rng(
            SEED_EM_NOISE).normal(0.0, 1.5, size=start.level_mean.shape)
        ck_dir = os.path.join(tmp, "em")
        os.makedirs(ck_dir)
        hk.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem7 = torch.cuda.memory_allocated()
        em_stages = []
        t0 = time.perf_counter()
        with Recorder(runner_mod) as rec7:
            em = em_train(rgs, reference, start, iterations=2, config=config,
                          update_transitions=True, update_emissions=True,
                          emission_prior_weight=5.0, checkpoint_dir=ck_dir,
                          write_expectations=True, device=dev,
                          stage_seconds=em_stages)
        t_em = time.perf_counter() - t0
        em_launches = {
            "sa_fwd_sweep": hk.forward_sweep.expect_launches,
            "sa_bwd_sweep_compact": hk.backward_sweep_compact.expect_launches}
        plain_launches = (hk.forward_sweep.launches,
                          hk.backward_sweep_compact.launches)
        peak = torch.cuda.max_memory_allocated()
        lls = em.log_likelihoods
        check(all(np.isfinite(lls)) and lls[-1] > lls[0],
              f"EM log-likelihoods {lls}")
        for probs in em.transitions_history:
            check(np.allclose(probs.sum(axis=1), 1.0, rtol=1e-9),
                  f"transition rows do not sum to 1: {probs}")
        err0 = np.abs(start.level_mean - model.level_mean)
        heavy = np.flatnonzero((em.kexp_history[0][0] > 3.0) & (err0 > 0.75))
        after = np.abs(em.model.level_mean[heavy] - model.level_mean[heavy])
        check(len(heavy) >= 10 and after.mean() < err0[heavy].mean(),
              f"emissions did not recover: {len(heavy)} heavy k-mers, mean "
              f"error {err0[heavy].mean():.4f} -> {after.mean():.4f} pA")
        check(all(em_launches.values()) and plain_launches == (0, 0),
              f"EM launches {em_launches}, plain instances {plain_launches}")
        # the iteration-0 expectations file reproduces checkpoint 0 through
        # the accumulator's summed slots, with em_train's M-step (prior
        # weight 5), at every k-mer the file's 9 decimals resolve (Σp >=
        # 1e-3)
        acc = ExpectationsAccumulator(synthetic_pore_model(SEED_MODEL))
        check(acc.add_file(em.expectations_files[0]), "no expectations file")
        ck0 = PoreModel.from_file(em.checkpoint_files[0])
        tr0 = acc.normalize_transitions()
        w, post = 5.0, acc.posteriors
        u = (acc.mean_expectations + start.level_mean * w) / (post + w)
        o = (np.sqrt(acc.sd_expectations / np.maximum(post, 1e-300)) * post
             + start.level_sd * w) / (post + w)
        well = acc.observed & (em.kexp_history[0][0] >= 1e-3)
        d_mean = float(np.abs(u - ck0.level_mean)[well].max())
        d_sd = float(np.abs(o - ck0.level_sd)[well].max())
        d_tr = float(np.abs(tr0.reshape(-1) - ck0.transitions).max())
        check(d_mean <= 1e-4 and d_sd <= 1e-4 and d_tr <= 1e-6,
              f"expectations file vs checkpoint: means {d_mean}, sds {d_sd}, "
              f"transitions {d_tr}")
        log(f"[em] {len(rgs)} reads, {n_events} events, 2 iterations: "
            f"log-likelihood {lls[0]:.2f} -> {lls[1]:.2f}; transitions "
            f"m->m {em.transitions_history[0][0, 0]:.5f} -> "
            f"{em.transitions_history[1][0, 0]:.5f}; {len(heavy)} heavy "
            f"k-mers, mean level error {err0[heavy].mean():.4f} -> "
            f"{after.mean():.4f} pA; file vs checkpoint |d| means "
            f"{d_mean:.2e}, sds {d_sd:.2e}, transitions {d_tr:.2e} "
            f"({int(well.sum())} k-mers)")
        for it, st in enumerate(em_stages):
            log(f"[em] iteration {it} stages " + " ".join(
                f"{s_}={v:.2f}s" for s_, v in st.items()))
        log(f"[em] em_train {t_em:.2f} s: {2 * n_events / t_em:.0f} events/s "
            f"over both iterations; kernels stage "
            f"{2 * n_events / sum(st['kernels'] for st in em_stages):.0f} "
            f"events/s; peak device memory {peak / 2**30:.2f} GiB (allocated "
            f"at the start {mem7 / 2**30:.2f} GiB)")
        log(f"[em] launches {em_launches} (plain instances {plain_launches})")
        # iteration 0's aligners (the two iterations make the same buckets)
        half = len(rec7.made) // 2
        made7 = rec7.made[:half]
        check([(w, p, len(q)) for w, p, q, _ in made7]
              == [(w, p, len(q)) for w, p, q, _ in rec7.made[half:]],
              "em_train's two iterations made other buckets")

        phase_mark("7d")
        # ---- 7d. threeStateHdp transition EM on the plain genome
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        with Recorder(runner_mod) as rec7d:
            em6 = em_train(rgs7d, plain6, model6, iterations=1,
                           config=dataclasses.replace(
                               config, emission_mode=bfb.MODE_HDP),
                           hdp=hdp6, device=dev)
        t_em6 = time.perf_counter() - t0
        hdp_em_launches = {
            "sa_fwd_sweep": hk.forward_sweep.expect_launches,
            "sa_bwd_sweep_compact": hk.backward_sweep_compact.expect_launches}
        ll6 = em6.log_likelihoods[0]
        check(np.isfinite(ll6) and ll6 > -1e29, f"HDP EM log-likelihood {ll6}")
        check(np.allclose(em6.transitions_history[0].sum(axis=1), 1.0,
                          rtol=1e-9), "HDP transition rows do not sum to 1")
        check(not em6.kexp_history[0].any(), "HDP kexp is not zero")
        check(all(hdp_em_launches.values()),
              f"HDP EM launches {hdp_em_launches}")
        n_ev7d = sum(r.n_events for r, _ in rgs7d)
        log(f"[em hdp] {len(rgs7d)} reads, {n_ev7d} events, "
            f"{sum(len(q) for _, _, q, _ in rec7d.made)} "
            f"segments: log-likelihood {ll6:.2f}, transitions m->m "
            f"{em6.transitions_history[0][0, 0]:.5f}, kexp zero; "
            f"{t_em6:.2f} s ({n_ev7d / t_em6:.0f} events/s); launches "
            f"{hdp_em_launches}")
        phase_mark("7a")
        # ---- 7a. expectation kernels against their twins, one bucket per
        # W class of 7c's (iteration 0) and 7d's aligners (the class's
        # shortest problem)
        check(all(P == 1 for _, P, _, _ in made7 + rec7d.made),
              "an EM segment has more than one path")
        tables = hdp_tables(*hdp6.density_arrays(), dev)
        exp_rows = {}
        for tag, made, tb in (("gauss", made7, None),
                              ("hdp", rec7d.made, tables)):
            for (W, _), probs in sorted(rec7.classes(made).items()):
                probs = probs[:1]
                pte = problem_tensors(probs, W, dev, tb, kmer_ids=True)
                r = expect_vs_twins(hk, bfb, pte, threshold, R)
                r["bounds"] = sweep_bounds(bfb, pte, r["n_kernel"], True)
                r["floor"] = [serial_floor_ms(hk, barrier, pte, True,
                                              backward=bwd)
                              for bwd in (False, True)]
                exp_rows[(tag, W)] = r
                log(f"[em kernels {tag} W={W} K="
                    f"{hk.cells_per_thread(W, 1, True)}/"
                    f"{hk.cells_per_thread(W, 1, True, True)}] "
                    f"{len(probs)} problems n_diag {min(pte.n_diag)}.."
                    f"{max(pte.n_diag)}: expect fwd {r['fwd_ms']:.3f} ms (twin "
                    f"{r['fwd_plain_ms']:.1f} ms, bound "
                    f"{r['bounds']['sa_fwd_sweep'][0]:.4f} ms), bwd "
                    f"{r['bwd_ms']:.3f} ms (twin {r['bwd_plain_ms']:.1f} ms, "
                    f"bound {r['bounds']['sa_bwd_sweep_compact'][0]:.4f} ms), "
                    f"floor {r['floor'][0]:.3f} / {r['floor'][1]:.3f} ms; "
                    "stacks, totals, survivors "
                    f"equal ({r['n_kernel']}); texp rel {r['texp_rel']:.3e} "
                    f"(abs {r['texp_abs']:.3e}, sum {r['texp_sum']:.1f}), kx "
                    f"rel {r['kx_rel']:.3e} (tol {TOL_EXPECT})")
        # the loop's names hold the HDP tables (pte.hdp too): free them
        # before phase 8 measures its own peak
        del tb, tables, pte
        log(f"[em kernels] instances held here K="
            f"{sorted({hk.cells_per_thread(W, 1, True) for _, W in exp_rows})}"
            "; tests/test_torch_kernels_cuda.py holds every K")
        # the eight longest W=256 problems of 7c's iteration 0: expectation
        # and plain instances on the same problems, by CUDA events
        long7 = sorted((p_ for W, _, probs, _ in made7 if W == 256
                        for p_ in probs), key=lambda q: -q.n_diag)[:8]
        check(len(long7) == 8, "fewer than 8 W=256 EM problems")
        ptl = problem_tensors(long7, 256, dev, kmer_ids=True)
        em_main = expect_vs_twins(hk, bfb, ptl, threshold, R)
        em_main["bounds"] = sweep_bounds(bfb, ptl, em_main["n_kernel"], True)
        em_main["floor"] = [serial_floor_ms(hk, barrier, ptl, True,
                                            backward=bwd)
                            for bwd in (False, True)]
        plain_f, plain_b = sweep_ms(hk, bfb, ptl, threshold, R, 5)
        log(f"[em kernels] 8 problems W=256 n_diag {min(ptl.n_diag)}.."
            f"{max(ptl.n_diag)}: expect fwd {em_main['fwd_ms']:.3f} ms, bwd "
            f"{em_main['bwd_ms']:.3f} ms (twins {em_main['fwd_plain_ms']:.1f}"
            f" / {em_main['bwd_plain_ms']:.1f} ms); plain instances on the "
            f"same problems fwd {plain_f:.3f} ms, bwd {plain_b:.3f} ms; "
            f"bounds " + ", ".join(
                f"{k} {v[0]:.4f} ms ({v[1]})"
                for k, v in em_main["bounds"].items())
            + f"; floor {em_main['floor'][0]:.3f} / "
            f"{em_main['floor'][1]:.3f} ms; texp rel "
            f"{em_main['texp_rel']:.3e}, kx rel {em_main['kx_rel']:.3e}")
        del ptl, long7

        log_kernel_sums("em", chunk_sums(
            hk, bfb, problem_tensors, rec7.chunks(made7), dev, threshold, R,
            expect=True), t_em / 2)
        del rec7, rec7d, made7

        phase_mark("8")
        # ---- 8. the probability-space path (SIGNALALIGN_TPU_PROB_KERNELS=1)
        # 8a. both probability-space kernels against their twins at 3a's
        # shape (W=256, ~4k diagonals) on the segments of eight error-free
        # reads: phase 4's reads follow their basecall errors, and every
        # segment of theirs exhausts the f32 window (as in the JAX
        # kernels), so values are held where it does not; then both
        # kernels and the log-space ones timed on 3a's own problems
        rng8 = np.random.default_rng(SEED_CLEAN)
        genome8 = reference.forward["synth"]
        clean = [synthetic_read(
            rng8, genome8, model, int(rng8.integers(0, len(genome8) - 2000)),
            int(rng8.integers(1400, 1700)), f"clean{i}", sub_rate=0.0,
            ins_rate=0.0, del_rate=0.0) for i in range(8)]
        # a band of 150 expansion puts them in 3a's bucket: W=256, Dpad
        # 4096, P=1
        clean_p = [q for W, Dpad, P, q in prepare_all(
            clean, reference, model,
            dataclasses.replace(config, diagonal_expansion=150))
            if (W, Dpad, P) == (256, 4096, 1)]
        check(len(clean_p) == 8, f"{len(clean_p)} error-free W=256 problems")
        ptc = problem_tensors(clean_p, 256, dev, prob=True)
        pa = prob_vs_twins(hk, bfb, ptc, threshold, R)
        check(not all(pa["tripped"]), "every error-free problem tripped")
        pa["bounds"] = sweep_bounds(bfb, ptc, pa["n_kernel"], prob=True)
        pa["floor"] = serial_floor_ms(hk, barrier, ptc, prob=True)
        pa["log_fwd_ms"], pa["log_bwd_ms"] = sweep_ms(
            hk, bfb, problem_tensors(clean_p, 256, dev), threshold, R, 5)
        log(f"[prob kernels] {len(ptc.n_diag)} problems of error-free reads, "
            f"W=256, n_diag {min(ptc.n_diag)}..{max(ptc.n_diag)}: "
            f"sa_fwd_sweep_prob {pa['fwd_ms']:.3f} ms (twin "
            f"{pa['fwd_plain_ms']:.1f} ms, log-space kernel "
            f"{pa['log_fwd_ms']:.3f} ms), sa_bwd_sweep_compact_prob "
            f"{pa['bwd_ms']:.3f} ms (twin {pa['bwd_plain_ms']:.1f} ms, "
            f"log-space {pa['log_bwd_ms']:.3f} ms); bounds " + ", ".join(
                f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in pa["bounds"].items())
            + f"; floor {pa['floor']:.3f} ms; tripped {pa['tripped']}; the "
            f"others |d total| {max(pa['tf_err'], pa['tb_err']):.3e} nats, "
            f"|d exp(fstack)| {pa['fdiff']:.3e}, |d posterior| "
            f"{pa['pdiff']:.3e} (tol {TOL_POST}), survivors {pa['n_kernel']} "
            f"vs {pa['n_twin']}")
        del ptc
        pa["3a_fwd_ms"], pa["3a_bwd_ms"] = sweep_ms(
            hk, bfb, problem_tensors(p3, 256, dev, prob=True), threshold, R, 5,
            prob=True)
        pa["3a_log_fwd_ms"], pa["3a_log_bwd_ms"] = sweep_ms(
            hk, bfb, problem_tensors(p3, 256, dev), threshold, R, 5)
        pa["3a_bounds"] = sweep_bounds(bfb, problem_tensors(
            p3, 256, dev, prob=True), p1["n_kernel"], prob=True)
        log(f"[prob kernels] 3a's 8 problems (all trip): sa_fwd_sweep_prob "
            f"{pa['3a_fwd_ms']:.3f} ms, log-space {pa['3a_log_fwd_ms']:.3f} ms; "
            f"sa_bwd_sweep_compact_prob {pa['3a_bwd_ms']:.3f} ms, log-space "
            f"{pa['3a_log_bwd_ms']:.3f} ms; bounds " + ", ".join(
                f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in pa["3a_bounds"].items())
            + f"; floor {p1_floor:.3f} ms")

        phase_mark("8b")
        # 8b. outlier segments: the guard flags the lanes that trip, and
        # the re-run gives them the log-space path's results
        outl = [bfb.prepare_problem(seq, ev, model, ScalingParams(),
                                    DEFAULT_AMBIG_BASES, W=512, Dpad=1024,
                                    P=1, anchor_pairs=[], expansion=60)
                for seq, ev in outlier_segments(model)]
        pb = prob_vs_twins(hk, bfb, problem_tensors(outl, 512, dev, prob=True),
                           threshold, R)
        check(pb["tripped"] == [True, False, True, False],
              f"outlier segments tripped {pb['tripped']}")
        res8 = hk.HopperAligner(outl, 512, dev, log_space=False).execute(threshold)
        exact = hk.HopperAligner(outl, 512, dev).execute(threshold)
        check([r["numerics_suspect"] for r in res8] == pb["tripped"],
              "the aligner flags other lanes than the sweeps trip")
        n_re = runner_mod.rerun_suspects(
            [(0, 0, 0, q, 512, 1024, 1) for q in outl], res8, range(len(outl)),
            dev, threshold)
        check(n_re == 2 and res8[0] == exact[0] and res8[2] == exact[2],
              "the re-run lanes differ from the log-space path")
        worst8 = max(compare_pairs(exact[i]["pairs"], res8[i]["pairs"],
                                   threshold) for i in (1, 3))
        dtot8 = max(abs(exact[i]["total_f"] - res8[i]["total_f"])
                    for i in (1, 3))
        check(worst8 <= TOL_PATH and dtot8 <= TOL_TOTAL,
              f"untripped outlier lanes: pairs {worst8}, totals {dtot8}")
        log(f"[prob outliers] lanes tripped {pb['tripped']} (kernel = twin, "
            f"flagged = tripped), {n_re} re-run equal to the log-space path; "
            f"the others |d total| {dtot8:.3e} nats, |d p| {worst8:.3e}")

        phase_mark("8c")
        # 8c. phase 4's reads with the switch set, against phase 4's output
        buckets4 = rec4.buckets()
        n_seg4 = sum(map(len, buckets4.values()))
        os.environ[runner_mod.PROB_SWITCH] = "1"
        want_prob = sum(len(_stack_chunks(list(range(len(v))), *k))
                        for k, v in buckets4.items()
                        if runner_mod.prob_bucket(k[0], k[2], len(v), config,
                                                  False))
        want_log = sum(len(_stack_chunks(list(range(len(v))), *k))
                       for k, v in buckets4.items()
                       if not runner_mod.prob_bucket(k[0], k[2], len(v),
                                                     config, False))
        wide = [k for k in buckets4 if k[0] > bfb.PROB_MAX_W]
        guard = []
        rerun0 = runner_mod.rerun_suspects

        def counted(tasks_, res_, ids, *a, **kw):
            n = rerun0(tasks_, res_, ids, *a, **kw)
            guard.append((n, len(ids)))
            return n

        runner_mod.rerun_suspects = counted
        hk.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem8 = torch.cuda.memory_allocated()
        stages = {}
        try:
            t0 = time.perf_counter()
            results = run_alignment_batch(rgs, reference, model, config,
                                          device=dev, stage_seconds=stages)
            t_prob = time.perf_counter() - t0
        finally:
            del os.environ[runner_mod.PROB_SWITCH]
            runner_mod.rerun_suspects = rerun0
        prob_launches = {
            "sa_fwd_sweep_prob": hk.forward_sweep_prob.launches,
            "sa_bwd_sweep_compact_prob": hk.backward_sweep_compact_prob.launches,
            "sa_fwd_sweep": hk.forward_sweep.launches,
            "sa_bwd_sweep_compact": hk.backward_sweep_compact.launches}
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        written = write_outputs(results, model, os.path.join(tmp, "out8"), "both")
        t_write = time.perf_counter() - t0
        check(len(results) == len(rgs), f"{len(rgs) - len(results)} reads failed")
        check(len(written) == len(main_results) * 2, f"{len(written)} files")
        worst8, dtot8 = 0.0, 0.0
        for a, g in zip(main_results, results):
            check(a.read_label == g.read_label and g.max_total_gap < 1.0,
                  f"{g.read_label}: gap {g.max_total_gap}")
            dtot8 = max(dtot8, abs(a.total_log_prob - g.total_log_prob))
            worst8 = max(worst8, compare_pairs(a.aligned_pairs, g.aligned_pairs,
                                               threshold))
        check(dtot8 <= 0.05 and worst8 <= TOL_PATH,
              f"switch on vs phase 4: totals {dtot8} nats, pairs {worst8}")
        n_flag, n_prob = guard[0] if guard else (0, 0)
        check(prob_launches["sa_fwd_sweep_prob"] == want_prob > 0
              and prob_launches["sa_bwd_sweep_compact_prob"] == want_prob
              and prob_launches["sa_fwd_sweep"] >= want_log > 0 and wide
              and n_prob > 0, f"launches {prob_launches}: want {want_prob} "
              f"probability-space chunks, >= {want_log} log-space ones (W > "
              f"512 buckets {wide}), {n_prob} segments in probability space")
        log(f"[prob main] {len(results)} reads, {n_events} events: "
            f"{n_prob} of {n_seg4} segments in probability space, "
            f"{n_flag} flagged and re-run ({n_flag / max(n_prob, 1):.4f}); "
            f"the others on the log-space kernels (W > 512 buckets {wide}); "
            f"vs phase 4 |d total| {dtot8:.3e} nats, |d p| {worst8:.3e}")
        log("[prob main] stages " + " ".join(
            f"{s_}={v:.2f}s" for s_, v in stages.items())
            + f" write={t_write:.2f}s")
        log(f"[prob main] run_alignment_batch {t_prob:.2f} s: "
            f"{n_events / t_prob:.0f} events/s (phase 4 in this run "
            f"{n_events / t_main:.0f}; kernels stage {main_stages['kernels']:.2f}"
            f" s there, {stages['kernels']:.2f} + rerun {stages.get('rerun', 0.0):.2f} s "
            f"here); peak device memory {peak / 2**30:.2f} GiB (allocated at "
            f"the start {mem8 / 2**30:.2f} GiB)")
        log(f"[prob main] launches {prob_launches}")

        phase_mark("8d")
        # 8d. probability-space against log-space kernel time on every
        # W <= 512 bucket of phase 4, in the runner's chunks, CUDA events
        sums8 = {}
        for (W, Dpad, P), probs in sorted(buckets4.items()):
            if W > bfb.PROB_MAX_W:
                continue
            for chunk in _stack_chunks(list(range(len(probs))), W, Dpad, P):
                sub = [probs[i] for i in chunk]
                e = sums8.setdefault(W, [0, 0.0, 0.0, 0.0, 0.0])
                e[0] += len(sub)
                f_ms, b_ms = sweep_ms(hk, bfb, problem_tensors(
                    sub, W, dev, prob=True), threshold, R, 1, prob=True)
                lf_ms, lb_ms = sweep_ms(hk, bfb, problem_tensors(sub, W, dev),
                                        threshold, R, 1)
                e[1:] = [e[1] + f_ms, e[2] + b_ms, e[3] + lf_ms, e[4] + lb_ms]
        for W, (n, f_ms, b_ms, lf_ms, lb_ms) in sorted(sums8.items()):
            log(f"[prob sums] W={W}: {n} problems, probability-space fwd "
                f"{f_ms:.3f} ms, bwd {b_ms:.3f} ms; log-space fwd {lf_ms:.3f} "
                f"ms, bwd {lb_ms:.3f} ms")
        tot8 = [sum(e[i] for e in sums8.values()) for i in range(1, 5)]
        log(f"[prob sums] W <= 512: probability-space fwd {tot8[0]:.3f} ms, "
            f"bwd {tot8[1]:.3f} ms; log-space fwd {tot8[2]:.3f} ms, bwd "
            f"{tot8[3]:.3f} ms")
        del buckets4, main_results, rec4

        phase_mark("9a")
        # ---- 9a. `run` from its files but the fast5s (no h5py on this
        # host): SAM, filter, guides, the written FASTA, align_and_write
        t0 = time.perf_counter()
        files = write_synthetic_run(rgs, os.path.join(tmp, "run9"),
                                    os.path.join(tmp, "genome.fa"),
                                    motifs=[("CG", "YG")], fast5=False)
        t_files = time.perf_counter() - t0
        t0 = time.perf_counter()
        records = list(read_alignment_file(files["sam"])[1])
        kept = [rec for rec in records if passes_filter(rec)]
        check(len(records) == len(rgs) + 3 and [rec.qname for rec in kept]
              == [read.read_label for read, _ in rgs],
              f"{len(kept)} of {len(records)} SAM records pass the filter")
        rgs9 = []
        for (read, guide), rec in zip(rgs, kept):
            g = guide_from_sam_record(rec)
            check(g is not None and g.validate(read.read_length)
                  and g == guide, f"{rec.qname}: guide from the SAM {g} "
                  f"differs from {guide}")
            rgs9.append((read, g))
        ref9 = ProcessedReference(files["fasta"])
        t_inputs = time.perf_counter() - t0
        check(ref9.forward == reference.forward
              and ref9.backward == reference.backward,
              "the written FASTA's reference differs from phase 4's")
        hk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        t0 = time.perf_counter()
        written9 = align_and_write(rgs9, ref9, model, os.path.join(tmp, "out9"),
                                   AlignmentConfig(), output_format="both",
                                   device=dev, stage_seconds=stages)
        t9 = time.perf_counter() - t0
        files_launches = {
            "sa_fwd_sweep": hk.forward_sweep.launches,
            "sa_bwd_sweep_compact": hk.backward_sweep_compact.launches}
        peak = torch.cuda.max_memory_allocated()
        n_same = same_files(written9, main_written)
        check(n_same == len(main_written),
              f"{len(main_written) - n_same} of {len(main_written)} files "
              "differ from phase 4's")
        check(all(files_launches.values()),
              f"a kernel was not launched from the files: {files_launches}")
        log(f"[files] {len(records)} SAM records, {len(kept)} kept, "
            f"{len(rgs9)} guides equal to the in-memory ones; "
            f"{n_same} of {len(main_written)} files byte-equal to phase 4's")
        log(f"[files] stages files={t_files:.2f}s sam_guides_fasta="
            f"{t_inputs:.2f}s " + " ".join(
                f"{s_}={v:.2f}s" for s_, v in stages.items()))
        log(f"[files] align_and_write {t9:.2f} s: {n_events / t9:.0f} "
            f"events/s, from the files {n_events / (t9 + t_inputs):.0f} "
            f"events/s; peak device memory {peak / 2**30:.2f} GiB")
        log(f"[files] launches {files_launches}")

        phase_mark("9b")
        # ---- 9b. the positions file's edition and site calling from it
        t0 = time.perf_counter()
        pos9 = AmbiguityPositions.from_file(files["positions"])
        ref9b = ProcessedReference(files["fasta"], positions=pos9)
        t_pos = time.perf_counter() - t0
        check(ref9b.forward == amb_ref.forward
              and ref9b.backward == amb_ref.backward,
              "the positions file's edition differs from phase 5's motif "
              "edition")
        hk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        t0 = time.perf_counter()
        written9b = align_and_write(
            rgs9, ref9b, model, os.path.join(tmp, "variants9"),
            AlignmentConfig(), output_format="variants", variants="CT",
            device=dev, stage_seconds=stages)
        t9b = time.perf_counter() - t0
        positions_launches = {
            "sa_fwd_sweep": hk.forward_sweep.launches,
            "sa_bwd_sweep_compact": hk.backward_sweep_compact.launches}
        peak = torch.cuda.max_memory_allocated()
        n_same, worst9 = compare_variant_files(written9b, sites_written)
        check(worst9 <= TOL_ORDER, f"variants probabilities differ from "
              f"phase 5's by {worst9} (tol {TOL_ORDER})")
        check(all(positions_launches.values()), "a kernel was not launched "
              f"from the positions file: {positions_launches}")
        log(f"[positions] {len(pos9.data)} positions rows, edition = "
            f"phase 5's; {n_same} of "
            f"{len(sites_written)} variants files byte-equal to phase 5's, "
            f"C and T within {worst9:.3e} (tol {TOL_ORDER})")
        log(f"[positions] stages positions_reference={t_pos:.2f}s " + " ".join(
            f"{s_}={v:.2f}s" for s_, v in stages.items()))
        log(f"[positions] align_and_write {t9b:.2f} s: {n_events / t9b:.0f} "
            f"events/s; peak device memory {peak / 2**30:.2f} GiB")
        log(f"[positions] launches {positions_launches}")

        phase_mark("10a")
        # ---- 10a. the expectation pass of the P > 2 instances (every
        # expectation bucket of P > 1, and P = 1 past 2,048 cells) and of
        # the wide instance against their twins, timed by CUDA events
        check(set(exp10_sets) >= {(256, 2), (256, 4), (256, 8),
                                  (WIDE_P1_W, 1)}, "10a's problem sets: "
              f"{sorted(exp10_sets)}")
        exp10_rows = {}
        for (W_, P_), probs in sorted(exp10_sets.items()):
            pte = problem_tensors(probs, W_, dev, kmer_ids=True)
            ks_ = [hk.cells_per_thread(W_, P_, True, b) for b in (0, 1)]
            # P = 2 within 2,048 cells may run the per-pair instance
            # widened to two paths (banded_fb.cu EXPECT_PAIR_P)
            check(all(ks_) and (P_ == 2 or all(k_ < 0 for k_ in ks_)),
                  f"the expectation pass of P = {P_} W = {W_} runs cells "
                  f"per thread {ks_}, not the P > 2 instances")
            # past 8,192 cells, the cluster instance
            wide_ = ks_[0] < -8
            cl_ = [hk.cluster_ctas(W_, P_, True, b_) for b_ in (0, 1)]
            check(not wide_ or all(cl_), f"the expectation pass of P = {P_} "
                  f"W = {W_} runs cluster blocks {cl_}")
            c0_ = (hk.forward_sweep.cluster_launches,
                   hk.backward_sweep_compact.cluster_launches)
            r = expect_vs_twins(hk, bfb, pte, threshold, R)
            check(not wide_ or (hk.forward_sweep.cluster_launches > c0_[0]
                                and hk.backward_sweep_compact.cluster_launches
                                > c0_[1]),
                  f"the expectation pass of P = {P_} W = {W_} launched no "
                  "cluster instance")
            r["bounds"] = sweep_bounds(bfb, pte, r["n_kernel"], True)
            r["floor"] = [serial_floor_ms(hk, barrier, pte, True,
                                          backward=bwd)
                          for bwd in (False, True)]
            r["plain"] = sweep_ms(hk, bfb, pte, threshold, R, 5)
            r["pair"] = ks_[0] > 0      # the per-pair instance at P = 2
            exp10_rows[(W_, P_)] = r
            nd_ = max(pte.n_diag)
            tag_ = f" (wide, cluster of {cl_[0]} / {cl_[1]})" if wide_ else ""
            log(f"[em kernels P={P_} W={W_} K={ks_[0]}/{ks_[1]}{tag_}] "
                f"{len(probs)} problems n_diag {min(pte.n_diag)}..{nd_}: "
                f"expect fwd {r['fwd_ms']:.3f} ms ({1e3 * r['fwd_ms'] / nd_:.2f} "
                f"us a diagonal; twin {r['fwd_plain_ms']:.1f} ms, bound "
                f"{r['bounds']['sa_fwd_sweep'][0]:.4f} ms by "
                f"{r['bounds']['sa_fwd_sweep'][1]}), bwd {r['bwd_ms']:.3f} "
                f"ms (twin {r['bwd_plain_ms']:.1f} ms, bound "
                f"{r['bounds']['sa_bwd_sweep_compact'][0]:.4f} ms by "
                f"{r['bounds']['sa_bwd_sweep_compact'][1]}); plain instances "
                f"{r['plain'][0]:.3f} / {r['plain'][1]:.3f} ms; floor "
                f"{r['floor'][0]:.3f} / {r['floor'][1]:.3f} ms; stacks, "
                f"totals, survivors equal ({r['n_kernel']}); texp rel "
                f"{r['texp_rel']:.3e} (sum {r['texp_sum']:.1f}), kx rel "
                f"{r['kx_rel']:.3e} (tol "
                f"{TOL_SPLIT if r['split'] else TOL_EXPECT})")
            if r["split"]:
                bd_ = r["bounds"]["sa_expect_sums"]
                log(f"[em kernels P={P_} W={W_}] split: the backward alone "
                    f"{r['stack_ms']:.3f} ms (its stored stack equal to the "
                    f"twin's; twin {r['stack_plain_ms']:.1f} ms), "
                    f"sa_expect_sums {r['sums_ms']:.4f} ms (twin "
                    f"{r['sums_plain_ms']:.1f} ms, bound {bd_[0]:.4f} ms by "
                    f"{bd_[1]}; texp rel {r['sums_texp_rel']:.3e}, kx rel "
                    f"{r['sums_kx_rel']:.3e}, tol {TOL_SPLIT}; two launches "
                    f"equal); together {r['bwd_ms']:.3f} ms = "
                    f"{r['bwd_ms'] / r['plain'][1]:.3f} x the plain backward")
            del pte
        del exp10_sets

        train_paths, train_pair2, train_sums = train_phases(dev, tmp,
                                                            phase_mark)
        raw_2d_launches = raw_2d_phases(dev, tmp, phase_mark, model,
                                        rgs[:N_RAW_11A], reference)

    def err(r, name):
        return max(r["tf_err"], r["fdiff"]) if name == "sa_fwd_sweep" \
            else max(r["tb_err"], r["pdiff"])

    kernels = []
    for name, src, ms in (
            ("sa_fwd_sweep", "signalalign_tpu/ops/banded_fb_pallas_batch.py:569 "
             "(+ signalalign_tpu/ops/banded_fb_pallas.py:216; its estream "
             "mode with signalalign_tpu/ops/emission_stream.py:75 and :46)",
             "fwd_"),
            ("sa_bwd_sweep_compact",
             "signalalign_tpu/ops/banded_fb_pallas_batch.py:775 "
             "(+ signalalign_tpu/ops/banded_fb_pallas.py:326, "
             "signalalign_tpu/ops/banded_fb_pallas_batch.py:1407; its "
             "estream mode with signalalign_tpu/ops/emission_stream.py:75 "
             "and :46)", "bwd_")):
        err_pn = max(err(r, name) for r in paths_rows.values())
        err_hdp = max(err(r, name) for r in hdp_rows.values())
        by_phase = {"4": launches[name], "5": site_launches[name],
                    "6": hdp_launches[name], "9a": files_launches[name],
                    "9b": positions_launches[name],
                    "11a": raw_2d_launches["11a"][name],
                    "11a_noisy": raw_2d_launches["11a_noisy"][name],
                    "11b": raw_2d_launches["11b"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "signalalign_tpu_torch/csrc/banded_fb.cu", "replaces": src,
            # the main-path runs (phases 4, 5, 6c, 9a, 9b, 11a and 11b),
            # each counted from 0
            "launches": sum(by_phase.values()),
            "max_abs_err": max(err(p1, name), err_pn, err_hdp),
            "ms": p1[ms + "ms"], "plain_ms": p1[ms + "plain_ms"],
            "bound_ms": p1_bounds[name][0], "bound_by": p1_bounds[name][1],
            # no single PyTorch call computes a banded pair-HMM sweep
            "library_ms": None,
            "serial_floor_ms": p1_floor,
            "launches_by_phase": by_phase,
            "max_abs_err_p1": err(p1, name), "max_abs_err_3c": err_pn,
            "max_abs_err_hdp": err_hdp,
            "ms_by_W_P": {f"{W},{P}": r[ms + "ms"]
                          for (W, P), r in paths_rows.items()},
            "plain_ms_by_W_P": {f"{W},{P}": r[ms + "plain_ms"]
                                for (W, P), r in paths_rows.items()},
            "bound_ms_by_W_P": {f"{W},{P}": b[name][0]
                                for (W, P), b in paths_bounds.items()},
            "ms_by_W_P_hdp": {f"{W},{P}": r[ms + "ms"]
                              for (W, P), r in hdp_rows.items()},
            "plain_ms_by_W_P_hdp": {f"{W},{P}": r[ms + "plain_ms"]
                                    for (W, P), r in hdp_rows.items()},
            "bound_ms_by_W_P_hdp": {f"{W},{P}": b[name][0]
                                    for (W, P), b in hdp_bounds.items()}})
    for name, src, ms in (
            ("sa_fwd_sweep", "signalalign_tpu/ops/banded_fb_pallas_batch.py:569"
             " (PP > 1, past 8,192 cells a diagonal)", "fwd_"),
            ("sa_bwd_sweep_compact",
             "signalalign_tpu/ops/banded_fb_pallas_batch.py:775 (PP > 1 "
             "fuse_post, + :1407, past 8,192 cells a diagonal)", "bwd_")):
        r64 = wide_rows[(segs64_w, 64)]
        kernels.append({
            "name": f"{name} (wide, cluster)", "route": "cuda",
            "source": "signalalign_tpu_torch/csrc/banded_fb.cu",
            "replaces": src,
            # 3c's P = 64 read through run_alignment_batch, counted from 0
            "launches": wide_launches[name],
            "max_abs_err": max(err(r, name) for r in wide_rows.values()),
            "ms": r64[ms + "ms"], "plain_ms": r64[ms + "plain_ms"],
            "bound_ms": wide_bounds[(segs64_w, 64)][name][0],
            "bound_by": wide_bounds[(segs64_w, 64)][name][1],
            "library_ms": None,
            "serial_floor_ms": r64["floor"],
            "launches_by_phase": {"3c": wide_launches[name]},
            "ms_by_W_P": {f"{W},{P}": r[ms + "ms"]
                          for (W, P), r in wide_rows.items()},
            "plain_ms_by_W_P": {f"{W},{P}": r[ms + "plain_ms"]
                                for (W, P), r in wide_rows.items()},
            "bound_ms_by_W_P": {f"{W},{P}": b[name][0]
                                for (W, P), b in wide_bounds.items()}})
        rs = scratch_rows[scratch_wp]
        kernels.append({
            "name": f"{name} (wide, scratch)", "route": "cuda",
            "source": "signalalign_tpu_torch/csrc/banded_fb.cu",
            "replaces": src + ", past the cluster instance's CAP",
            # 3c's P = 256 read through run_alignment_batch, counted from
            # 0; its times, bound and floor those of its segment
            "launches": scratch_launches[name],
            "max_abs_err": max(err(r, name) for r in scratch_rows.values()),
            "ms": rs[ms + "ms"], "plain_ms": rs[ms + "plain_ms"],
            "bound_ms": scratch_bounds[scratch_wp][name][0],
            "bound_by": scratch_bounds[scratch_wp][name][1],
            "library_ms": None,
            "serial_floor_ms": rs["floor"],
            "launches_by_phase": {"3c": scratch_launches[name]},
            "ms_by_W_P": {f"{W},{P}": r[ms + "ms"]
                          for (W, P), r in scratch_rows.items()},
            "plain_ms_by_W_P": {f"{W},{P}": r[ms + "plain_ms"]
                                for (W, P), r in scratch_rows.items()},
            "bound_ms_by_W_P": {f"{W},{P}": b[name][0]
                                for (W, P), b in scratch_bounds.items()}})
    for name, src, ms in (
            ("sa_fwd_sweep", "signalalign_tpu/ops/banded_fb_pallas_batch.py:569"
             " (expect mode, :740-745)", "fwd_"),
            ("sa_bwd_sweep_compact",
             "signalalign_tpu/ops/banded_fb_pallas_batch.py:775 (expect mode, "
             ":971-1015; its kexp reduction :2116 is kexp_by_kmer)", "bwd_")):
        by_phase = {"7c": em_launches[name], "7d": hdp_em_launches[name]}
        kernels.append({
            "name": f"{name} (expect)", "route": "cuda",
            "source": "signalalign_tpu_torch/csrc/banded_fb.cu",
            "replaces": src,
            "launches": sum(by_phase.values()),
            # stacks, totals and survivors are equal bit for bit (checked);
            # the float64 expectation sums differ from the twin's by this
            "max_abs_err": max(max(r["texp_abs"], r["kx_abs"])
                               for r in list(exp_rows.values()) + [em_main])
            if name == "sa_bwd_sweep_compact" else 0.0,
            "ms": em_main[ms + "ms"], "plain_ms": em_main[ms + "plain_ms"],
            "bound_ms": em_main["bounds"][name][0],
            "bound_by": em_main["bounds"][name][1],
            "library_ms": None,
            "serial_floor_ms": em_main["floor"][ms == "bwd_"],
            "launches_by_phase": by_phase,
            "plain_instance_ms": plain_f if ms == "fwd_" else plain_b,
            "max_rel_err_texp": max(r["texp_rel"] for r in exp_rows.values()),
            "max_rel_err_kx": max(r["kx_rel"] for r in exp_rows.values()),
            "ms_by_W": {f"{t},{W}": r[ms + "ms"]
                        for (t, W), r in exp_rows.items()},
            "plain_ms_by_W": {f"{t},{W}": r[ms + "plain_ms"]
                              for (t, W), r in exp_rows.items()},
            "bound_ms_by_W": {f"{t},{W}": r["bounds"][name][0]
                              for (t, W), r in exp_rows.items()}})
    paths10 = {k_: r for k_, r in exp10_rows.items() if not r["pair"]}
    pair10 = {k_: r for k_, r in exp10_rows.items() if r["pair"]}
    for name, src, ms in (
            ("sa_fwd_sweep", "signalalign_tpu/ops/banded_fb_pallas_batch.py:569"
             " (expect mode, :740-745) and, at P > 1, the XLA expectation "
             "core signalalign_tpu/ops/banded_fb.py:642", "fwd_"),
            ("sa_bwd_sweep_compact",
             "signalalign_tpu/ops/banded_fb_pallas_batch.py:775 (expect mode, "
             ":971-1015) and, at P > 1, signalalign_tpu/ops/banded_fb.py:642",
             "bwd_")):
        for tag, rows, r_, counts in (
                ("P > 2 instances", paths10, paths10[(256, 8)], train_paths),
                ("per-pair instance at P = 2", pair10, pair10[(256, 2)],
                 train_pair2)):
            kernels.append({
                "name": f"{name} (expect, {tag})", "route": "cuda",
                "source": "signalalign_tpu_torch/csrc/banded_fb.cu",
                "replaces": src,
                # 10b's transitions EM (train_models), counted from 0
                "launches": counts[name],
                "max_abs_err": max(max(r["texp_abs"], r["kx_abs"])
                                   for r in rows.values())
                if name == "sa_bwd_sweep_compact" else 0.0,
                "ms": r_[ms + "ms"], "plain_ms": r_[ms + "plain_ms"],
                "bound_ms": r_["bounds"][name][0],
                "bound_by": r_["bounds"][name][1],
                "library_ms": None,
                "serial_floor_ms": r_["floor"][ms == "bwd_"],
                "launches_by_phase": {"10b": counts[name]},
                "max_rel_err_texp": max(r["texp_rel"] for r in rows.values()),
                "max_rel_err_kx": max(r["kx_rel"] for r in rows.values()),
                "ms_by_W_P": {f"{W},{P}": r[ms + "ms"]
                              for (W, P), r in rows.items()},
                "plain_instance_ms_by_W_P": {
                    f"{W},{P}": r["plain"][ms == "bwd_"]
                    for (W, P), r in rows.items()},
                "plain_ms_by_W_P": {f"{W},{P}": r[ms + "plain_ms"]
                                    for (W, P), r in rows.items()},
                "bound_ms_by_W_P": {f"{W},{P}": r["bounds"][name][0]
                                    for (W, P), r in rows.items()}})
            if name == "sa_bwd_sweep_compact":
                # the register instances' buckets: ms is the backward and
                # sa_expect_sums together, as the wrapper runs them
                kernels[-1]["backward_alone_ms_by_W_P"] = {
                    f"{W},{P}": r["stack_ms"] for (W, P), r in rows.items()
                    if r["split"]}
    # sa_expect_sums on the register instances' 10a classes (P = 8 at W =
    # 256 the headline), launched by 10b's transitions EM
    sums10 = {k_: r for k_, r in exp10_rows.items() if r["split"]}
    r_ = sums10[(256, 8)]
    kernels.append({
        "name": "sa_expect_sums", "route": "cuda",
        "source": "signalalign_tpu_torch/csrc/banded_fb.cu",
        "replaces": "signalalign_tpu/ops/banded_fb_pallas_batch.py:971-1015 "
                    "(the sums of _bwd_kernel_log's expect mode) and the XLA "
                    "expectation core signalalign_tpu/ops/banded_fb.py:642, "
                    "on the P > 2 register instances' buckets",
        # 10b's transitions EM (train_models), counted from 0
        "launches": train_sums,
        "max_abs_err": max(r["sums_abs"] for r in sums10.values()),
        "ms": r_["sums_ms"], "plain_ms": r_["sums_plain_ms"],
        "bound_ms": r_["bounds"]["sa_expect_sums"][0],
        "bound_by": r_["bounds"]["sa_expect_sums"][1],
        # no PyTorch call computes these sums
        "library_ms": None,
        "launches_by_phase": {"10b": train_sums},
        "max_rel_err_texp": max(r["sums_texp_rel"] for r in sums10.values()),
        "max_rel_err_kx": max(r["sums_kx_rel"] for r in sums10.values()),
        "ms_by_W_P": {f"{W},{P}": r["sums_ms"] for (W, P), r in sums10.items()},
        "plain_ms_by_W_P": {f"{W},{P}": r["sums_plain_ms"]
                            for (W, P), r in sums10.items()},
        "bound_ms_by_W_P": {f"{W},{P}": r["bounds"]["sa_expect_sums"][0]
                            for (W, P), r in sums10.items()}})
    for name, src, ms, tot in (
            ("sa_fwd_sweep_prob",
             "signalalign_tpu/ops/banded_fb_pallas_batch.py:161", "fwd_", 0),
            ("sa_bwd_sweep_compact_prob",
             "signalalign_tpu/ops/banded_fb_pallas_batch.py:371", "bwd_", 1)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "signalalign_tpu_torch/csrc/banded_fb_prob.cu",
            "replaces": src,
            "launches": prob_launches[name],
            "max_abs_err": max(err(r, name.replace("_prob", ""))
                               for r in (pa, pb)),
            "ms": pa[ms + "ms"], "plain_ms": pa[ms + "plain_ms"],
            "bound_ms": pa["bounds"][name][0],
            "bound_by": pa["bounds"][name][1],
            # no PyTorch call computes this sweep
            "library_ms": None,
            "serial_floor_ms": pa["floor"],
            "launches_by_phase": {"8c": prob_launches[name]},
            "log_space_ms": pa["log_" + ms + "ms"],
            "ms_3a": pa["3a_" + ms + "ms"],
            "log_space_ms_3a": pa["3a_log_" + ms + "ms"],
            "bound_ms_3a": pa["3a_bounds"][name][0],
            "sums_w_le_512_ms": tot8[tot],
            "log_space_sums_w_le_512_ms": tot8[tot + 2]})
    phase_mark("end")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernel-sums"]:
        kernel_sums_of_tree(sys.argv[2] if len(sys.argv) > 2
                             else os.path.dirname(os.path.abspath(__file__)))
    else:
        main()
