"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure stops the run with a non-zero exit):
  1. the device: name and power limit (nvidia-smi), torch and CUDA versions;
  2. the kernel build from signalalign_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch twin on the card, on 8 problems
     of the phase-4 batch (W=256, about 4k diagonals), with its time;
     then the whole main path on the GPU against the CPU (twins) on the
     batch's two shortest reads;
  4. the main path at a realistic size: 64 synthetic reads (about 1M
     events, 5-mer ACGT model) through run_alignment_batch on the GPU and
     write_outputs("both"), with the output checks, stage times, events/s
     and peak device memory, and the kernels' launch counts in that run.
The last two lines are a JSON object per kernel and the result line
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

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
SEED_MODEL, SEED_READS = 0, 1


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def survivors(slot_off, slot_val, cnt, R):
    """{(problem, diagonal, offset): posterior} of the first cnt slots."""
    keep = torch.arange(R, device=cnt.device) < cnt[:, :, None]
    b, d, _ = keep.nonzero(as_tuple=True)
    o = slot_off[keep]
    v = slot_val[keep]
    return {(int(bi), int(di), int(oi)): float(vi) for bi, di, oi, vi in
            zip(b.tolist(), d.tolist(), o.tolist(), v.tolist())}


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
    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from signalalign_tpu_torch.convert import problem_tensors
    from signalalign_tpu_torch.ops import banded_fb as bfb
    from signalalign_tpu_torch.ops import banded_fb_hopper as hk
    from signalalign_tpu_torch.pipeline.runner import (prepare_read,
                                                       run_alignment_batch,
                                                       write_outputs)
    from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
    from signalalign_tpu_torch.utils import cuda_build
    from signalalign_tpu_torch.utils.synthetic import (build_synthetic_batch,
                                                       synthetic_pore_model)
    check("jax" not in sys.modules, "the port imported jax")

    # ---- 2. build
    b = cuda_build.build()
    log(f"[build] {b.path} in {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    cuda_build.load()

    with tempfile.TemporaryDirectory() as tmp:
        model = synthetic_pore_model(SEED_MODEL)
        rgs, reference, _, _, _ = build_synthetic_batch(
            model, n_reads=64, ev_min=2000, ev_max=50000, seed=SEED_READS,
            genome_len=400_000, fasta_path=os.path.join(tmp, "genome.fa"))
        config = AlignmentConfig()
        threshold = config.threshold
        R = hk.survivor_slots(threshold)

        # ---- 3a. kernels against their twins on the card
        picked = []
        for read, guide in rgs:
            segs = prepare_read(read, guide, reference, model, config)[4]
            picked += [p for _, p, W, Dpad, _ in segs
                       if W == 256 and Dpad == 4096 and p.n_diag >= 3500]
            if len(picked) >= 8:
                break
        check(len(picked) >= 8, "batch has fewer than 8 W=256 ~4k-diagonal problems")
        picked = picked[:8]
        pt = problem_tensors(picked, 256, dev)
        nds = torch.tensor([p.n_diag for p in picked], device=dev)
        log(f"[kernels] 8 problems W=256 n_diag {min(pt.n_diag)}..{max(pt.n_diag)}")

        t0 = time.perf_counter()
        f_ref, fi_ref, lf_ref = hk.forward_sweep_ref(pt)
        torch.cuda.synchronize()
        fwd_plain_ms = (time.perf_counter() - t0) * 1e3
        hk.forward_sweep(pt)                                     # warm-up
        fwd_ms, (f_k, fi_k, lf_k) = cuda_ms(lambda: hk.forward_sweep(pt), 5)
        _, tf_k = bfb.forward_offsets(fi_k, lf_k, nds)
        fo_ref, tf_ref = bfb.forward_offsets(fi_ref, lf_ref, nds)
        rows = torch.arange(pt.x0.shape[1], device=dev)[None, :] <= nds[:, None]
        fdiff = (f_k.exp() - f_ref.exp()).abs().amax(dim=2)[rows].max().item()
        tf_err = (tf_k - tf_ref).abs().max().item()
        log(f"[kernels] sa_fwd_sweep {fwd_ms:.3f} ms, twin {fwd_plain_ms:.1f} ms; "
            f"|d total_f| {tf_err:.3e} nats (tol {TOL_TOTAL}), "
            f"|d exp(fstack)| {fdiff:.3e} (tol {TOL_POST})")
        check(tf_err <= TOL_TOTAL and fdiff <= TOL_POST,
              "sa_fwd_sweep disagrees with forward_sweep_ref")

        cvecf = (fo_ref - tf_ref[:, None]).contiguous()
        t0 = time.perf_counter()
        bref = hk.backward_sweep_compact_ref(pt, f_ref, cvecf, threshold, R)
        torch.cuda.synchronize()
        bwd_plain_ms = (time.perf_counter() - t0) * 1e3
        hk.backward_sweep_compact(pt, f_ref, cvecf, threshold, R)   # warm-up
        bwd_ms, bk = cuda_ms(lambda: hk.backward_sweep_compact(
            pt, f_ref, cvecf, threshold, R), 5)
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
        log(f"[kernels] sa_bwd_sweep_compact {bwd_ms:.3f} ms, twin {bwd_plain_ms:.1f} ms; "
            f"|d total_b| {tb_err:.3e} nats, survivors {len(sk)} vs {len(sr)}, "
            f"|d posterior| {pdiff:.3e} (tol {TOL_POST})")
        check(tb_err <= TOL_TOTAL and pdiff <= TOL_POST,
              "sa_bwd_sweep_compact disagrees with backward_sweep_compact_ref")
        del f_ref, f_k, bref, bk

        # ---- 3b. the main path on the GPU against the CPU (twins)
        small = sorted(rgs, key=lambda rg: rg[0].events.shape[0])[:2]
        on_cpu = run_alignment_batch(small, reference, model, config,
                                     device=torch.device("cpu"))
        on_gpu = run_alignment_batch(small, reference, model, config, device=dev)
        check(len(on_cpu) == len(on_gpu) == 2, "small batch lost a read")
        worst = 0.0
        for a, g in zip(on_cpu, on_gpu):
            check(abs(a.total_log_prob - g.total_log_prob) <= TOL_TOTAL,
                  f"{a.read_label}: total {g.total_log_prob} vs cpu {a.total_log_prob}")
            worst = max(worst, compare_pairs(a.aligned_pairs, g.aligned_pairs,
                                             threshold))
        check(worst <= TOL_PATH, f"pair posteriors differ by {worst}")
        log(f"[small] {[r.events.shape[0] for r, _ in small]} events: gpu = cpu "
            f"within {TOL_TOTAL} nats, |d p| {worst:.3e} (tol {TOL_PATH})")

        # ---- 4. the main path at a realistic size
        hk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        t0 = time.perf_counter()
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
            f"peak device memory {peak / 2**30:.2f} GiB")
        log(f"[main] launches {launches}")

    kernels = [
        {"name": "sa_fwd_sweep", "route": "cuda",
         "source": "signalalign_tpu_torch/csrc/banded_fb.cu",
         "replaces": "signalalign_tpu/ops/banded_fb_pallas_batch.py:569 "
                     "(+ signalalign_tpu/ops/banded_fb_pallas.py:216)",
         "launches": launches["sa_fwd_sweep"],
         "max_abs_err": max(tf_err, fdiff),
         "ms": fwd_ms, "plain_ms": fwd_plain_ms},
        {"name": "sa_bwd_sweep_compact", "route": "cuda",
         "source": "signalalign_tpu_torch/csrc/banded_fb.cu",
         "replaces": "signalalign_tpu/ops/banded_fb_pallas_batch.py:775 "
                     "(+ signalalign_tpu/ops/banded_fb_pallas.py:326)",
         "launches": launches["sa_bwd_sweep_compact"],
         "max_abs_err": max(tb_err, pdiff),
         "ms": bwd_ms, "plain_ms": bwd_plain_ms},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
