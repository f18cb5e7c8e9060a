"""Command-line interface of the port: the ``run`` subcommand (alias
``run2``) and the ``train`` subcommand of ``signalalign_tpu.cli``,
runSignalAlign's and trainModels' equivalents.

reference: scripts/runSignalAlign.py (run/run2 subcommands, JSON config)
and src/signalalign/train/trainModels.py.
The JSON config schema follows the reference's documented keys
(README.md:85-251) where they map onto the pipeline; process-pool keys
(job_count etc.) are accepted and ignored. ``--device`` picks the torch
device (default ``cuda``; ``cpu`` runs the kernels' plain versions).
``run`` takes fast5s with event tables or raw signal only,
``--force_kmer_event_alignment``, ``--embed`` and ``--2d`` with
``--complement_model``; ``train`` takes ``--2d`` / ``--complement_model``
(the complement strand's EM). The other subcommands of the JAX CLI are
not ported yet.

Usage:
  python -m signalalign_tpu_torch.cli run --config config.json
  python -m signalalign_tpu_torch.cli run --alignment_file x.bam \\
      --readdb x.readdb --fast5_dir d/ --ref ref.fa --model m.model \\
      --output_dir out/ [--device cpu]
  python -m signalalign_tpu_torch.cli run --2d --fast5_dir d/ --ref ref.fa \\
      --model t.model --complement_model c.model --output_dir out/
  python -m signalalign_tpu_torch.cli train --config trainModels-config.json \\
      [--device cpu]
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

    if args.twod:
        from signalalign_tpu_torch.pipeline.runner import run_signal_align_2d
        cmodel_path = args.complement_model or cfg.get("complement_hmm_model")
        missing = [n for n, v in [("fast5_dir", fast5_dirs), ("ref", ref),
                                  ("model", model_path),
                                  ("complement_model", cmodel_path)] if not v]
        if missing:
            print(f"missing required arguments: {missing}", file=sys.stderr)
            return 1
        config = AlignmentConfig(
            threshold=float(args.threshold),
            diagonal_expansion=int(args.diagonal_expansion),
            constraint_trim=int(args.constraint_trim))
        written = run_signal_align_2d(
            fast5_dirs=fast5_dirs, reference_fasta=ref,
            template_model=PoreModel.from_file(model_path),
            complement_model=PoreModel.from_file(cmodel_path),
            output_dir=output_dir, config=config,
            output_format=args.output_format, max_reads=args.max_reads,
            device=torch.device(args.device))
        print(f"[signalalign_tpu_torch] wrote {len(written)} output files to "
              f"{output_dir}")
        return 0

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


def cmd_train(args) -> int:
    from signalalign_tpu_torch.io.fast5 import import_h5py
    from signalalign_tpu_torch.io.guide import guide_from_sam_record
    from signalalign_tpu_torch.io.reference import ProcessedReference
    from signalalign_tpu_torch.io.sam import filter_reads
    from signalalign_tpu_torch.models.hdp_model import load_nhdp
    from signalalign_tpu_torch.models.pore_model import PoreModel
    from signalalign_tpu_torch.io.read import NanoporeReadData
    from signalalign_tpu_torch.pipeline.train import (sample_reference,
                                                      train_complement,
                                                      train_models)

    cfg = _load_config(args.config)
    training = cfg.get("training", {})
    if args.distributed:
        raise NotImplementedError(
            "train --distributed: EM across hosts is not ported yet "
            "(ROADMAP §1 item 5)")
    # complement-strand training (2D chemistry): the reference trains
    # both strand HMMs (trainModels twoD path)
    cmodel_path = args.complement_model or cfg.get("complement_hmm_model")
    complement = bool(cmodel_path and (args.twod
                                       or training.get("complement", False)))
    # multi-sample training: expectations pool over every sample block
    # (trainModels.py samples[] semantics); CLI read-source arguments
    # define exactly one sample
    samples = cfg.get("samples") or [_sample_from_config(cfg)]
    if args.alignment_file or args.readdb or args.fast5_dir:
        samples = [samples[0]]
    ref = args.ref or cfg.get("reference") or samples[0].get("bwa_reference")
    model_path = args.model or cfg.get("template_hmm_model")
    output_dir = args.output_dir or cfg.get("output_dir") or "training_out"
    iterations = int(args.iterations or training.get("em_iterations", 3))

    em_hdp = None
    smt = (training.get("stateMachineType") or cfg.get("stateMachineType")
           or "threeState")
    if smt == "threeStateHdp":
        # HdpHmm transition EM needs a trained .nhdp beside the .model
        hdp_path = (cfg.get("template_hdp_model")
                    or training.get("template_hdp_model"))
        if not hdp_path:
            print("threeStateHdp training requires template_hdp_model",
                  file=sys.stderr)
            return 2
        em_hdp = load_nhdp(hdp_path)

    import_h5py()       # before any file is read: fast5 input needs it
    model = PoreModel.from_file(model_path)
    reference = ProcessedReference(ref)

    sample_refs = [sample_reference(s, reference, ref) for s in samples]
    pairs = []          # (fast5, sam record, sample index)
    for si, sample in enumerate(samples):
        fast5_dirs = args.fast5_dir or sample.get("fast5_dirs") or []
        if isinstance(fast5_dirs, str):
            fast5_dirs = [fast5_dirs]
        pairs.extend((f5, rec, si) for f5, rec in filter_reads(
            args.alignment_file or sample.get("alignment_file"),
            args.readdb or sample.get("readdb"), fast5_dirs))
    if args.max_reads:
        pairs = pairs[:args.max_reads]
    rgs = []            # (read, guide, sample reference) triples
    rgs_by_sample = [[] for _ in samples]
    for f5, rec, si in pairs:
        # a fast5 without an event table is skipped, as the JAX train
        # skips it (cli.py:205-213): only run aligns raw signal
        try:
            read = NanoporeReadData.from_fast5(f5)
            guide = guide_from_sam_record(rec)
            if guide and guide.validate(read.read_length):
                rgs.append((read, guide, sample_refs[si]))
                rgs_by_sample[si].append((read, guide))
        except Exception as exc:
            print(f"[train] skipping {f5}: {exc}", file=sys.stderr)
    if not rgs:
        raise ValueError(f"train: none of the {len(pairs)} listed reads "
                         "loaded with a valid guide alignment; no model "
                         "is trained on zero reads")

    c_rgs = []          # complement strands of the samples' 2D fast5s
    if complement:
        c_rgs = complement_reads(samples, args.fast5_dir, reference)
        if args.max_reads:
            c_rgs = c_rgs[:args.max_reads]

    out = train_models(cfg, samples, sample_refs, rgs, rgs_by_sample,
                       reference, model, output_dir, iterations, em_hdp,
                       device=torch.device(args.device))
    if c_rgs:
        cres = train_complement(
            c_rgs, reference, PoreModel.from_file(cmodel_path), output_dir,
            iterations, bool(training.get("em_emissions", False)),
            device=torch.device(args.device))
        print(f"[train] complement log-likelihoods: {cres.log_likelihoods}")
        print(f"[train] wrote {output_dir}/complement_trained.model")
    if "nhdp" in out:
        print(f"[train] wrote {out['nhdp']}")
    if out["em"] is not None:
        print(f"[train] log-likelihoods: {out['em'].log_likelihoods}")
    print(f"[train] wrote {out['model_path']}")
    return 0


def complement_reads(samples, fast5_dir_args, reference):
    """(complement strand, guide) of every 2D fast5 in the samples'
    ``fast5_dirs`` (or in ``fast5_dir_args``, the CLI's, once), each
    mapped by its 2D sequence, as the JAX ``train`` collects them
    (``cli.py:319-345``); a read that does not load or map is skipped
    with its message; a native library that cannot be built raises."""
    from signalalign_tpu_torch.pipeline.runner import (read_2d,
                                                       twod_fast5_paths)
    from signalalign_tpu_torch.utils.native import NativeLibraryError
    c_rgs = []
    for sample in samples:
        dirs = fast5_dir_args or sample.get("fast5_dirs") or []
        if isinstance(dirs, str):
            dirs = [dirs]
        for f5 in twod_fast5_paths(dirs):
            try:
                read2d, guide = read_2d(f5, reference)
                c_rgs.append((read2d.complement, guide))
            except NativeLibraryError:
                raise
            except Exception as exc:
                print(f"[train] skipping complement {f5}: {exc}",
                      file=sys.stderr)
        if fast5_dir_args:
            break
    return c_rgs


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
                      help="regenerate event tables from raw signal even "
                           "when basecall events exist")
    runp.add_argument("--distributed", action="store_true",
                      help="shard the read list over hosts (not ported "
                           "yet)")
    runp.add_argument("--embed", action="store_true",
                      help="write alignment + MEA labels into the fast5s")
    runp.add_argument("--2d", dest="twod", action="store_true",
                      help="2D chemistry: align template + complement")
    runp.add_argument("--complement_model")
    runp.add_argument("--device", default="cuda",
                      help="torch device to align on (default cuda)")
    runp.set_defaults(func=cmd_run)

    trainp = sub.add_parser("train", help="train models (trainModels)")
    trainp.add_argument("--config")
    trainp.add_argument("--alignment_file")
    trainp.add_argument("--readdb")
    trainp.add_argument("--fast5_dir", action="append")
    trainp.add_argument("--ref")
    trainp.add_argument("--model")
    trainp.add_argument("--output_dir")
    trainp.add_argument("--iterations", type=int)
    trainp.add_argument("--max_reads", type=int)
    trainp.add_argument("--complement_model",
                        help="train a complement-strand model too (2D "
                             "chemistry; reads from the 2D fast5s)")
    trainp.add_argument("--2d", dest="twod", action="store_true",
                        help="2D chemistry: with a complement model, train "
                             "it on the 2D fast5s' complement strands")
    trainp.add_argument("--distributed", action="store_true",
                        help="EM across hosts (not ported yet)")
    trainp.add_argument("--device", default="cuda",
                        help="torch device to align on (default cuda)")
    trainp.set_defaults(func=cmd_train)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
