"""Command-line interface of the port: the ``run`` subcommand (alias
``run2``) of ``signalalign_tpu.cli``, runSignalAlign's equivalent.

reference: scripts/runSignalAlign.py (run/run2 subcommands, JSON config).
The JSON config schema follows the reference's documented keys
(README.md:85-251) where they map onto the pipeline; process-pool keys
(job_count etc.) are accepted and ignored. ``--device`` picks the torch
device (default ``cuda``; ``cpu`` runs the kernels' plain versions).
The other subcommands of the JAX CLI are not ported yet.

Usage:
  python -m signalalign_tpu_torch.cli run --config config.json
  python -m signalalign_tpu_torch.cli run --alignment_file x.bam \\
      --readdb x.readdb --fast5_dir d/ --ref ref.fa --model m.model \\
      --output_dir out/ [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch


def _load_config(path: Optional[str]) -> dict:
    if path is None:
        return {}
    with open(path) as fh:
        return json.load(fh)


def _sample_from_config(cfg: dict) -> dict:
    samples = cfg.get("samples")
    if samples:
        return samples[0]
    return cfg


def cmd_run(args) -> int:
    from signalalign_tpu_torch.io.guide import TargetRegions
    from signalalign_tpu_torch.io.reference import AmbiguityPositions
    from signalalign_tpu_torch.models.hdp_model import load_nhdp
    from signalalign_tpu_torch.models.pore_model import PoreModel
    from signalalign_tpu_torch.ops import banded_fb as bfb
    from signalalign_tpu_torch.pipeline.runner import run_signal_align
    from signalalign_tpu_torch.pipeline.signal_align import AlignmentConfig
    from signalalign_tpu_torch.utils.alphabet import load_ambig_model

    if args.twod:
        raise NotImplementedError(
            "run --2d: 2D reads are not ported yet (ROADMAP §1 item 6)")
    cfg = _load_config(args.config)
    sample = _sample_from_config(cfg)

    alignment_file = args.alignment_file or sample.get("alignment_file")
    readdb = args.readdb or sample.get("readdb")
    fast5_dirs = args.fast5_dir or sample.get("fast5_dirs") or []
    if isinstance(fast5_dirs, str):
        fast5_dirs = [fast5_dirs]
    ref = args.ref or cfg.get("reference") or sample.get("bwa_reference")
    model_path = args.model or cfg.get("template_hmm_model")
    output_dir = args.output_dir or cfg.get("output_dir") or "signalalign_out"
    hdp_path = args.hdp or cfg.get("template_hdp_model")

    missing = [n for n, v in [("alignment_file", alignment_file),
                              ("fast5_dir", fast5_dirs),
                              ("ref", ref), ("model", model_path)] if not v]
    if missing:
        print(f"missing required arguments: {missing}", file=sys.stderr)
        return 1

    model = PoreModel.from_file(model_path)
    hdp = load_nhdp(hdp_path) if hdp_path else None
    positions = None
    pf = args.positions_file or sample.get("positions_file")
    if pf:
        positions = AmbiguityPositions.from_file(pf)
    motifs = sample.get("motifs")

    ambig_map = None
    am = args.ambig_model or sample.get("ambig_model")
    if am:
        ambig_map = load_ambig_model(am)
    config = AlignmentConfig(
        threshold=float(args.threshold),
        diagonal_expansion=int(args.diagonal_expansion),
        constraint_trim=int(args.constraint_trim),
        emission_mode=bfb.MODE_HDP if hdp else bfb.MODE_MEAN_ONLY,
        **({"ambig_map": ambig_map} if ambig_map else {}),
    )
    written = run_signal_align(
        alignment_file=alignment_file, readdb=readdb, fast5_dirs=fast5_dirs,
        reference_fasta=ref, model=model, output_dir=output_dir,
        config=config, output_format=args.output_format,
        positions=positions, motifs=motifs, hdp=hdp,
        max_reads=args.max_reads, embed=args.embed,
        force_kmer_event_alignment=args.force_kmer_event_alignment,
        target_regions=(TargetRegions(args.target_regions)
                        if args.target_regions else None),
        quality_threshold=float(cfg.get("filter_reads", 7.0) or 7.0),
        distributed=args.distributed, variants=args.variants,
        device=torch.device(args.device))
    print(f"[signalalign_tpu_torch] wrote {len(written)} output files to "
          f"{output_dir}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="signalalign_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    runp = sub.add_parser("run", help="align reads (runSignalAlign)",
                          aliases=["run2"])
    runp.add_argument("--config")
    runp.add_argument("--alignment_file")
    runp.add_argument("--readdb")
    runp.add_argument("--fast5_dir", action="append")
    runp.add_argument("--ref")
    runp.add_argument("--model")
    runp.add_argument("--hdp")
    runp.add_argument("--positions_file")
    runp.add_argument("--target_regions",
                      help="2-column tsv restricting alignments to regions")
    runp.add_argument("--ambig_model",
                      help="custom ambiguity-expansion table (tsv)")
    runp.add_argument("--output_dir")
    runp.add_argument("--output_format", default="full",
                      choices=["full", "variantCaller", "both",
                               "assignments", "variants"])
    runp.add_argument("--variants",
                      help="candidate bases for --output_format=variants "
                           "(e.g. CE for CpG methylation); derived from "
                           "the ambiguity map when omitted")
    runp.add_argument("--threshold", default=0.01)
    runp.add_argument("--diagonal_expansion", default=50)
    runp.add_argument("--constraint_trim", default=14)
    runp.add_argument("--max_reads", type=int)
    runp.add_argument("--force_kmer_event_alignment", action="store_true",
                      help="regenerate event tables from raw signal (not "
                           "ported yet)")
    runp.add_argument("--distributed", action="store_true",
                      help="shard the read list over hosts (not ported "
                           "yet)")
    runp.add_argument("--embed", action="store_true",
                      help="write alignment + MEA labels into the fast5s "
                           "(not ported yet)")
    runp.add_argument("--2d", dest="twod", action="store_true",
                      help="2D chemistry (not ported yet)")
    runp.add_argument("--device", default="cuda",
                      help="torch device to align on (default cuda)")
    runp.set_defaults(func=cmd_run)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
