"""Seeded synthetic inputs for the port's tests and ``chip_smoke.py``.

``synthetic_genome``, ``synthetic_read`` and ``build_synthetic_batch`` are
the port's copy of ``signalalign_tpu.utils.synthetic``: from one seed they
draw the same genome, reads and guides. Reads are generated FROM the pore
model over a random genome with a nanopore-like error process, so the
guide anchors carry realistic gaps and the band geometry (bulges, splits,
width classes) has a real flowcell's diversity:

  * read lengths log-uniform over a caller-chosen event range;
  * substitution/insertion/deletion errors build the guide CIGAR;
  * events per k-mer follow a geometric stay distribution (~1.4x);
  * motif editions of the reference (CpG ambiguity) give the natural
    P in {2, 4, 8} mix of methylation workloads.

``synthetic_hdp`` builds an HDP emission model over a pore model's
k-mers, and ``write_nhdp_text`` writes a small one as an ``.nhdp`` file
that both packages' ``load_nhdp`` read. ``outlier_segments`` makes
segments whose range exhausts the probability-space DP's f32 window.
``write_synthetic_run`` writes reads held in memory as the files the
CLI's ``run`` reads: fast5 files (basecalled, raw signal only, or 2D), a
readdb, a SAM file, the FASTA, a positions file and the pore model.
``raw_signal_read`` and ``twod_read`` are the in-memory twins of its raw
and 2D fast5s, for hosts without h5py.
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from signalalign_tpu_torch.io.fast5 import (BASECALL_EVENT_COLUMNS, adc_to_pA,
                                            import_h5py)
from signalalign_tpu_torch.io.guide import GuideAlignment
from signalalign_tpu_torch.io.read import NanoporeRead2DData, NanoporeReadData
from signalalign_tpu_torch.io.reference import (ProcessedReference, iter_fasta,
                                                make_positions_file)
from signalalign_tpu_torch.models.hdp_model import NanoporeHDP
from signalalign_tpu_torch.models.pore_model import PoreModel, ScalingParams
from signalalign_tpu_torch.utils.alphabet import reverse_complement

BASES = "ACGT"
# synthetic_hdp's heavy tail: weight and sd (pA) of its broad component
TAIL_WEIGHT = 0.05
TAIL_SD = 15.0


def synthetic_pore_model(seed: int, alphabet: str = "ACGT",
                         k: int = 5) -> PoreModel:
    """A PoreModel with random level and noise tables drawn from ``seed``
    (levels 60-120 pA, level sd 1-2 pA)."""
    rng = np.random.default_rng(seed)
    model = PoreModel(alphabet, k)
    model.level_mean = rng.uniform(60, 120, model.num_kmers)
    model.level_sd = rng.uniform(1.0, 2.0, model.num_kmers)
    model.noise_mean = rng.uniform(0.8, 1.5, model.num_kmers)
    model.noise_sd = rng.uniform(0.1, 0.3, model.num_kmers)
    model.noise_lambda = model.noise_mean ** 3 / model.noise_sd ** 2
    return model


def methylated_pore_model(model: PoreModel, mod: str = "E", base: str = "C",
                          shift: float = 3.0) -> PoreModel:
    """A copy of ``model`` in which each k-mer carrying the modified base
    ``mod`` takes the level of the same k-mer with ``base`` in its place,
    plus ``shift`` pA for each ``mod``, and that k-mer's level sd: a
    modification that moves the current a few pA, as 5-mC does, where
    ``synthetic_pore_model`` draws every k-mer's level independently."""
    out = copy.deepcopy(model)
    a = model.alphabet
    for kid in range(a.num_kmers):
        kmer = a.index_to_kmer(kid)
        n = kmer.count(mod)
        if n:
            src = a.kmer_index(kmer.replace(mod, base))
            out.level_mean[kid] = model.level_mean[src] + shift * n
            out.level_sd[kid] = model.level_sd[src]
    return out


def synthetic_hdp(model: PoreModel, seed: int, grid_start: float = 30.0,
                  grid_stop: float = 180.0,
                  grid_length: int = 1200) -> NanoporeHDP:
    """A ``singleLevelFixed``-shaped HDP over every k-mer of ``model``,
    sampled on np.linspace(grid_start, grid_stop, grid_length) (the
    trainer's default grid) with the density's derivative as the knot
    slopes. Every k-mer is observed. Per k-mer the density is a Gaussian
    at the model's level_mean with sd level_sd times a width factor drawn
    from ``seed`` in [1, 1.25), mixed with weight TAIL_WEIGHT with a
    Gaussian of sd TAIL_SD at the same mean: the heavy tail an HDP
    posterior predictive has. Without it the density underflows to 0 in
    float32 some 13 sd from the level, and every alignment of a read with
    a basecall error (an event no reference k-mer explains) has
    probability 0. k-mers with an E keep the model's own random levels,
    so C and E paths separate. Tables are float32 (46,656 x 1,200 x 4 B =
    224 MB each for ACEGOT 6-mers), built 4,096 k-mers at a time."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(grid_start, grid_stop, grid_length)
    K = model.num_kmers
    sd = model.level_sd * rng.uniform(1.0, 1.25, K)
    dens = np.empty((K, grid_length), np.float32)
    slopes = np.empty((K, grid_length), np.float32)
    chunk = 4096
    for k0 in range(0, K, chunk):
        dx = grid[None, :] - model.level_mean[k0:k0 + chunk, None]
        d = np.zeros(dx.shape)
        s = np.zeros(dx.shape)
        for w, sig in ((1.0 - TAIL_WEIGHT, sd[k0:k0 + chunk, None]),
                       (TAIL_WEIGHT, TAIL_SD)):
            pdf = w * np.exp(-0.5 * (dx / sig) ** 2) / (sig * np.sqrt(2 * np.pi))
            d += pdf
            s -= dx / sig ** 2 * pdf
        dens[k0:k0 + chunk] = d
        slopes[k0:k0 + chunk] = s
    return NanoporeHDP(alphabet=model.alphabet, grid=grid, densities=dens,
                       slopes=slopes, observed=np.ones(K, bool), num_dps=K)


def write_nhdp_text(hdp: NanoporeHDP, path: str) -> str:
    """Write ``hdp`` as an ``.nhdp`` file (serialize_nhdp's layout, one DP
    per k-mer with no parent, finalized splines, full float precision),
    for small tables: at 46,656 k-mers x 1,200 points the text is ~1 GB."""
    fmt = "{:.17g}".format
    a = hdp.alphabet
    n = hdp.densities.shape[0]
    g = hdp.grid
    with open(path, "w") as fh:
        fh.write(f"{a.size}\n{a.letters}\n{a.kmer_length}\n")
        fh.write(f"1\n1\n0\n{n}\n")     # finalized, data, no gamma, DPs
        fh.write("0\n0\n")                 # data, dp ids
        fh.write("0 1 1 1\n")               # mu nu alpha beta
        fh.write(f"{fmt(g[0])} {fmt(g[-1])} {len(g)}\n")
        fh.write("1\n")                     # gamma params
        fh.write("- 0\n" * n)               # parent, factor children
        for table in (hdp.densities, hdp.slopes):
            for row in np.asarray(table, np.float64):
                fh.write(" ".join(fmt(v) for v in row) + "\n")
    return path


def synthetic_genome(rng: np.random.Generator, length: int = 400_000) -> str:
    return "".join(rng.choice(list(BASES), size=length))


def write_genome_fasta(genome: str, path: str, contig: str = "synth") -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(f">{contig}\n")
        for i in range(0, len(genome), 10000):
            fh.write(genome[i:i + 10000] + "\n")
    os.replace(tmp, path)
    return path


def synthetic_read(rng: np.random.Generator, genome: str, model: PoreModel,
                   start: int, n_bases: int, label: str,
                   sub_rate: float = 0.05, ins_rate: float = 0.03,
                   del_rate: float = 0.03, stay_p: float = 0.28,
                   contig: str = "synth",
                   event_motif: Optional[Tuple[str, str]] = None
                   ) -> Tuple[NanoporeReadData, GuideAlignment]:
    """One read + its guide alignment from a genome window.

    The error process walks the reference window emitting M/I/D runs
    (the guide CIGAR a real basecall+aligner would produce); events are
    sampled per READ k-mer from the model's Gaussians with a geometric
    stay count (mean 1/(1-stay_p) events per k-mer). ``event_motif``
    (e.g. ("CG", "EG"): a fully CpG-methylated sample) draws the events
    from the read's sequence with that motif edited, while the read's
    basecall keeps the unedited bases, as a real basecall would; the
    random draws are the same as without it.
    """
    k = model.kmer_length
    ref_seq = genome[start:start + n_bases]
    read_chars: List[str] = []
    ops: List[List] = []    # run-length [count, op]

    def push(op: str):
        if ops and ops[-1][1] == op:
            ops[-1][0] += 1
        else:
            ops.append([1, op])

    i = 0
    while i < len(ref_seq):
        r = rng.random()
        if r < del_rate:
            push("D")
            i += 1
            continue
        if r < del_rate + ins_rate:
            read_chars.append(BASES[rng.integers(4)])
            push("I")
            continue
        c = ref_seq[i]
        if r < del_rate + ins_rate + sub_rate:
            c = BASES[(BASES.index(c) + 1 + rng.integers(3)) % 4]
        read_chars.append(c)
        push("M")
        i += 1
    read_seq = "".join(read_chars)
    if len(read_seq) < 2 * k:
        raise ValueError("window too small for a read")

    events, event_map = draw_events(
        rng, read_seq.replace(*event_motif) if event_motif else read_seq,
        model, stay_p)
    read = NanoporeReadData(
        read_label=label, template_read=read_seq, events=events,
        event_map=event_map, model_states=None, p_model_state=None,
        kmer_length=k, params=ScalingParams(), rna=False)
    guide = GuideAlignment(
        contig=contig, forward=True, window_start=start,
        window_end=start + n_bases, query_start=0,
        query_end=len(read_seq),
        ops=[(int(n), op) for n, op in ops])
    return read, guide


def draw_events(rng: np.random.Generator, seq: str, model: PoreModel,
                stay_p: float = 0.28) -> Tuple[np.ndarray, np.ndarray]:
    """Events of ``seq`` under ``model`` as ``synthetic_read`` draws them:
    a geometric count per k-mer (at most 8), each event's mean from the
    k-mer's level Gaussian and its noise around the k-mer's noise mean,
    2 ms long. Returns (events (n, 4), event map with one entry per
    base)."""
    k = model.kmer_length
    ids = model.alphabet.seq_to_kmer_ids(seq)
    n_ev_per = 1 + rng.geometric(1.0 - stay_p, size=len(ids)) - 1
    n_ev_per = np.minimum(n_ev_per, 8)
    total = int(n_ev_per.sum())
    means = np.repeat(model.level_mean[ids], n_ev_per) \
        + np.repeat(model.level_sd[ids], n_ev_per) \
        * rng.standard_normal(total)
    noises = np.abs(np.repeat(model.noise_mean[ids], n_ev_per)
                    + rng.standard_normal(total))
    event_map = np.concatenate(
        [np.concatenate([[0], np.cumsum(n_ev_per)[:-1]]),
         np.full(k - 1, total - 1)]).astype(np.int64)
    events = np.stack([means, noises,
                       np.full(total, 0.002),
                       np.arange(total) * 0.002], axis=1)
    return events, event_map


def build_synthetic_batch(model: PoreModel, n_reads: int = 100,
                          ev_min: int = 1000, ev_max: int = 100_000,
                          seed: int = 0, genome_len: int = 400_000,
                          stay_p: float = 0.28,
                          fasta_path: Optional[str] = None,
                          ambig_frac: float = 0.0,
                          ambig_motif: Tuple[str, str] = ("CG", "YG"),
                          event_motif: Optional[Tuple[str, str]] = None):
    """A flowcell-like read batch: (rgs, reference, ambig_rgs,
    ambig_reference, fasta_path). ``event_motif`` draws every read's events
    from its motif-edited sequence (``synthetic_read``).

    Read event counts are log-uniform in [ev_min, ev_max]. The first
    ``ambig_frac`` of reads are returned separately with a motif-edited
    reference edition (``ambig_motif``). The genome is written to
    ``fasta_path`` (default: a file named by seed and length in the
    temporary directory) unless a file is already there: pass a fresh
    path.
    """
    rng = np.random.default_rng(seed)
    genome = synthetic_genome(rng, genome_len)
    if fasta_path is None:
        fasta_path = os.path.join(tempfile.gettempdir(),
                                  f"signalalign_synth_{seed}_{genome_len}.fa")
    if not os.path.exists(fasta_path):
        write_genome_fasta(genome, fasta_path)
    reference = ProcessedReference(fasta_path)
    n_ambig = int(round(n_reads * ambig_frac))
    ambig_reference = (ProcessedReference(fasta_path, motifs=[ambig_motif])
                       if n_ambig else None)

    ev_targets = np.exp(rng.uniform(np.log(ev_min), np.log(ev_max),
                                    size=n_reads))
    rgs, ambig_rgs = [], []
    mean_ev_per_base = 1.0 / (1.0 - stay_p)
    for ri, ev_t in enumerate(ev_targets):
        n_bases = max(int(ev_t / mean_ev_per_base), 4 * model.kmer_length)
        start = int(rng.integers(0, max(genome_len - n_bases - 1, 1)))
        read, guide = synthetic_read(rng, genome, model, start, n_bases,
                                     label=f"synth{ri}", stay_p=stay_p,
                                     event_motif=event_motif)
        (ambig_rgs if ri < n_ambig else rgs).append((read, guide))
    return rgs, reference, ambig_rgs, ambig_reference, fasta_path


# sampling rate (Hz) behind the raw_start / raw_length columns of written
# event tables
SAMPLE_RATE = 4000.0


def _fastq_qualities(rng: np.random.Generator, n: int, low: bool) -> str:
    """Phred+33 qualities: 8-30 per base, or 2-5 for a low-quality read."""
    lo, hi = (2, 6) if low else (8, 31)
    return "".join(chr(33 + q) for q in rng.integers(lo, hi, n))


def _basecall_events(read: NanoporeReadData) -> np.ndarray:
    """``read``'s events as a basecaller's event table
    (``BASECALL_EVENT_COLUMNS``). Each k-mer's events are those from its
    ``event_map`` entry to the next k-mer's: the first carries move 1
    (0 for the read's first event) and p_model_state 1, its stays move 0
    and p_model_state 0, so ``make_event_map`` keeps each k-mer's first
    event (a constant p_model_state would move k-mer 0's entry to its
    second event). It pads the trailing k - 1 bases with the last k-mer's
    first event, where ``synthetic_read`` maps them to the read's last
    event: the two maps differ there when the last k-mer has stays."""
    k = read.kmer_length
    n_kmers = read.read_length - k + 1
    starts = np.asarray(read.event_map[:n_kmers], dtype=np.int64)
    n = read.n_events
    first = np.zeros(n, bool)
    first[starts] = True
    kmer_of = np.cumsum(first) - 1
    table = np.zeros(n, dtype=BASECALL_EVENT_COLUMNS)
    table["start"] = read.events[:, 3]
    table["length"] = read.events[:, 2]
    table["mean"] = read.events[:, 0]
    table["stdv"] = read.events[:, 1]
    table["model_state"] = [read.template_read[j:j + k].encode()
                            for j in kmer_of]
    table["move"] = first.astype(np.int32)
    table["move"][0] = 0
    table["raw_start"] = np.rint(read.events[:, 3] * SAMPLE_RATE)
    table["raw_length"] = np.rint(read.events[:, 2] * SAMPLE_RATE)
    table["p_model_state"] = first.astype(np.float64)
    return table


# raw-signal fast5s: one channel's parameters (an R9.4 flowcell's), and
# the samples around a read: trim_and_segment_raw cuts 200 samples before
# it and 10 after it, and drops the samples past the last whole chunk of
# 100, so the tail pads the signal to whole chunks. Lead and tail step
# between two levels every 10 samples: any 100 of them hold 50 of each,
# so a chunk of them has a median absolute deviation of 30 pA, above the
# least of the read's chunks, and the MAD trim keeps the read
CHANNEL = {"digitisation": 8192.0, "offset": 10.0, "range": 1402.882,
           "sampling_rate": SAMPLE_RATE}
RAW_LEAD, RAW_TAIL, RAW_CHUNK = 200, 10, 100


def _steps(n: int) -> np.ndarray:
    return np.where((np.arange(n) // 10) % 2 == 0, 70.0, 130.0)


def raw_adc(read: NanoporeReadData, noise: float = 0.0,
            seed: int = 0) -> np.ndarray:
    """``read``'s raw signal as int16 ADC samples under ``CHANNEL``: each
    event becomes round(length * SAMPLE_RATE) samples (8 at 2 ms) around
    its mean, between a lead of RAW_LEAD samples and a tail. Each sample
    scatters by ``noise`` times its event's stdv (Gaussian, drawn from
    ``seed``): 1.0 is what a real event's stdv, its samples' spread,
    says. At 0 the samples carry no noise beyond the ADC step and the
    t-statistic detector (``ops.event_detect``) finds 1.07-1.09x the
    drawn events; at 1.0 it splits 8-sample events into 1.5x, and every
    read still passes the raw alignment's QC."""
    n = np.maximum(np.rint(read.events[:, 2] * SAMPLE_RATE).astype(np.int64),
                   1)
    level = np.repeat(read.events[:, 0], n)
    if noise:
        rng = np.random.default_rng(seed)
        level = level + noise * np.repeat(read.events[:, 1], n) \
            * rng.standard_normal(len(level))
    tail = RAW_TAIL + (-(RAW_LEAD + len(level) + RAW_TAIL)) % RAW_CHUNK
    pa = np.concatenate([_steps(RAW_LEAD), level, _steps(tail)])
    cp = CHANNEL
    return np.rint(pa * cp["digitisation"] / cp["range"]
                   - cp["offset"]).astype(np.int16)


def raw_start_time(read_number: int) -> int:
    """The start time (samples) written for read ``read_number``."""
    return 4000 * (read_number + 1)


def raw_signal_read(read: NanoporeReadData, read_number: int,
                    noise: float = 0.0):
    """The in-memory twin of a raw fast5 ``write_synthetic_run`` writes
    with the same ``noise``: (current in pA as ``Fast5.raw_signal_pA``
    reads it, the channel parameters as ``Fast5.channel_params`` does,
    the start time), the arguments of
    ``pipeline.event_align.align_raw_signal``."""
    return (adc_to_pA(raw_adc(read, noise, read_number), CHANNEL),
            dict(CHANNEL),
            float(raw_start_time(read_number)))


def synthetic_complement(rng: np.random.Generator, read: NanoporeReadData,
                         model: PoreModel, stay_p: float = 0.28
                         ) -> NanoporeReadData:
    """The complement strand of a 2D read whose template strand is
    ``read``: the events of its sequence's reverse complement drawn under
    ``model`` (``draw_events``)."""
    seq = reverse_complement(read.template_read)
    events, event_map = draw_events(rng, seq, model, stay_p)
    return NanoporeReadData(
        read_label=read.read_label, template_read=seq, events=events,
        event_map=event_map, model_states=None, p_model_state=None,
        kmer_length=model.kmer_length, params=ScalingParams(), rna=False)


def build_synthetic_2d_batch(model: PoreModel, complement_model: PoreModel,
                             seed: int = 0, **kw):
    """2D reads: ``build_synthetic_batch(model, seed=seed, **kw)``'s reads
    as template strands, each with a complement strand drawn under
    ``complement_model`` from a generator seeded ``seed + 1``. Returns
    (rgs, complements, reference, fasta_path)."""
    rgs, reference, _, _, fasta = build_synthetic_batch(model, seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    complements = [synthetic_complement(rng, read, complement_model)
                   for read, _ in rgs]
    return rgs, complements, reference, fasta


# the quality of every base of a 2D read's strand Fastqs (phred 20)
TWOD_QUALITY = chr(33 + 20)


def twod_tables(read: NanoporeReadData, complement: NanoporeReadData):
    """What a 2D fast5 holds of ``read`` and its complement strand: the
    Basecall_2D alignment table (one row per k-mer of the read: the
    template strand's first event of that k-mer, the complement strand's
    first event of the reverse-complement k-mer over the same bases, the
    k-mer) and per strand (basecall event table, Fastq, Model attributes),
    the arguments of ``NanoporeRead2DData.from_tables``."""
    k = read.kmer_length
    seq = read.template_read
    n_kmers = len(seq) - k + 1
    table = np.zeros(n_kmers, dtype=[("template", "<i8"),
                                     ("complement", "<i8"),
                                     ("kmer", f"S{k}")])
    table["template"] = read.event_map[:n_kmers]
    table["complement"] = complement.event_map[:n_kmers][::-1]
    table["kmer"] = [seq[i:i + k].encode() for i in range(n_kmers)]
    strands = {}
    for name, strand in (("template", read), ("complement", complement)):
        fastq = (f"@{read.read_label}\n{strand.template_read}\n+\n"
                 f"{TWOD_QUALITY * strand.read_length}\n")
        strands[name] = (_basecall_events(strand), fastq, {})
    return table, strands


def twod_read(read: NanoporeReadData,
              complement: NanoporeReadData) -> NanoporeRead2DData:
    """The in-memory twin of a 2D fast5 ``write_synthetic_run`` writes."""
    return NanoporeRead2DData.from_tables(read.read_label,
                                          *twod_tables(read, complement))


def _write_fast5(path: str, read_id: str, read_number: int,
                 read: NanoporeReadData, fastq: str, *,
                 events: bool = True, signal: bool = False,
                 noise: float = 0.0,
                 complement: Optional[NanoporeReadData] = None) -> None:
    """One read in the layout ``io.fast5.Fast5`` reads: the Raw read group
    with its read_id and the 1D basecall's template Events and Fastq; with
    ``signal`` the read's raw signal (``raw_adc`` at ``noise``), the
    channel parameters and a start time; without ``events`` no Analyses
    group; with a ``complement`` strand, the 2D read's tables
    (``twod_tables``): both strands under Basecall_1D_000 and the
    alignment table and 2D Fastq under Basecall_2D_000."""
    h5py = import_h5py()
    with h5py.File(path, "w") as fh:
        fh.create_group("UniqueGlobalKey/context_tags").attrs[
            "experiment_type"] = np.bytes_("genomic_dna")
        grp = fh.create_group(f"Raw/Reads/Read_{read_number}")
        grp.attrs["read_id"] = np.bytes_(read_id)
        grp.attrs["read_number"] = read_number
        grp.attrs["start_time"] = 0
        if signal:
            grp.attrs["start_time"] = raw_start_time(read_number)
            grp.create_dataset("Signal",
                               data=raw_adc(read, noise, read_number))
            fh.create_group("UniqueGlobalKey/channel_id").attrs.update(
                CHANNEL)
        base = "Analyses/Basecall_1D_000/BaseCalled_"
        if complement is not None:
            table, strands = twod_tables(read, complement)
            for name, (ev, fq, _) in strands.items():
                fh.create_dataset(f"{base}{name}/Events", data=ev)
                fh.create_dataset(f"{base}{name}/Fastq", data=np.bytes_(fq))
            twod = "Analyses/Basecall_2D_000/BaseCalled_2D"
            fh.create_dataset(f"{twod}/Alignment", data=table)
            fh.create_dataset(f"{twod}/Fastq", data=np.bytes_(fastq))
        elif events:
            fh.create_dataset(f"{base}template/Events",
                              data=_basecall_events(read))
            fh.create_dataset(f"{base}template/Fastq", data=np.bytes_(fastq))


def _sam_line(qname: str, flag: int, rname: str, pos: int, mapq: int,
              cigar: str, seq: str, qual: str) -> str:
    return "\t".join([qname, str(flag), rname, str(pos), str(mapq), cigar,
                      "*", "0", "0", seq, qual]) + "\n"


def _primary_record(read: NanoporeReadData, guide: GuideAlignment,
                    qual: str) -> str:
    """The SAM record that ``guide_from_sam_record`` turns back into
    ``guide``: the read's bases outside the query range soft-clipped and,
    for a reverse-mapped guide, flag 16 with SEQ reverse-complemented,
    QUAL reversed and the ops (read orientation) reversed."""
    head = guide.query_start
    tail = read.read_length - guide.query_end
    ops, seq, flag = list(guide.ops), read.template_read, 0
    if not guide.forward:
        ops, seq, qual = ops[::-1], reverse_complement(seq), qual[::-1]
        flag, head, tail = 0x10, tail, head
    cigar = "".join(f"{n}{op}" for n, op in [(head, "S"), *ops, (tail, "S")]
                    if n)
    return _sam_line(read.read_label, flag, guide.contig,
                     guide.window_start + 1, guide.mapq, cigar, seq, qual)


def write_synthetic_run(rgs: Sequence[Tuple[NanoporeReadData, GuideAlignment]],
                        out_dir: str, fasta_path: str, *,
                        model: Optional[PoreModel] = None,
                        motifs: Optional[List[Tuple[str, str]]] = None,
                        fast5: bool = True, raw: bool = False,
                        signal: bool = False, noise: float = 0.0,
                        complements: Optional[Sequence[NanoporeReadData]]
                        = None) -> Dict[str, str]:
    """Write reads held in memory (``build_synthetic_batch``) as the inputs
    of the CLI's ``run``, under ``out_dir``; returns their paths by key:

    * "fasta": a copy of ``fasta_path`` (the reads' genome);
    * "fast5_dir": one ``<label>.fast5`` per read (``_basecall_events``,
      and a Fastq with qualities drawn from a fixed seed), when ``fast5``;
      writing them needs h5py. With ``raw`` each holds the read's raw
      signal (``raw_adc``) and no Analyses group, as a fast5 before
      basecalling; with ``signal`` the raw signal beside the event table;
      ``noise`` scatters the raw samples (``raw_adc``);
      with ``complements`` (each read's complement strand,
      ``build_synthetic_2d_batch``) each is a 2D read (``twod_tables``);
    * "readdb": a read id and its fast5 file name per line;
    * "sam": ``@SQ`` headers, then each read's primary record
      (``_primary_record``: forward or reverse-mapped, clipped or not,
      quality as in its Fastq) and three records
      ``filter_reads`` drops: a secondary record of the first read, an
      unmapped read and a read whose mean quality is below 7 (both in the
      readdb, their fast5 files copies of the first read's);
    * "positions": a positions file of ``motifs`` (``make_positions_file``,
      e.g. [("CG", "YG")]), when given;
    * "model": ``model`` in the .model format, when given.
    """
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    paths = {"fasta": os.path.join(out_dir, "reference.fa"),
             "fast5_dir": os.path.join(out_dir, "fast5"),
             "readdb": os.path.join(out_dir, "reads.readdb"),
             "sam": os.path.join(out_dir, "reads.sam")}
    shutil.copyfile(fasta_path, paths["fasta"])
    os.makedirs(paths["fast5_dir"], exist_ok=True)
    label0 = rgs[0][0].read_label
    decoys = {"unmapped": f"{label0}_unmapped", "lowq": f"{label0}_lowq"}
    records, fastqs = [], {}
    for i, (read, guide) in enumerate(rgs):
        qual = _fastq_qualities(rng, read.read_length, low=False)
        fastqs[read.read_label] = (i, read, qual)
        records.append(_primary_record(read, guide, qual))
    read0, guide0 = rgs[0]
    n0 = read0.read_length
    records.insert(1, _sam_line(label0, 0x100, guide0.contig,
                                guide0.window_start + 1, 0, f"{n0}M",
                                read0.template_read,
                                fastqs[label0][2]))
    records.append(_sam_line(decoys["unmapped"], 0x4, "*", 0, 0, "*",
                             read0.template_read, fastqs[label0][2]))
    low = _fastq_qualities(rng, n0, low=True)
    records.append(_sam_line(decoys["lowq"], 0, guide0.contig,
                             guide0.window_start + 1, guide0.mapq,
                             "".join(f"{n}{op}" for n, op in guide0.ops),
                             read0.template_read, low))
    fastqs[decoys["unmapped"]] = (len(rgs), read0, fastqs[label0][2])
    fastqs[decoys["lowq"]] = (len(rgs) + 1, read0, low)
    with open(paths["sam"], "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:unsorted\n")
        for name, seq in iter_fasta(paths["fasta"]):
            fh.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\n")
        fh.writelines(records)
    with open(paths["readdb"], "w") as fh:
        for label in fastqs:
            fh.write(f"{label}\t{label}.fast5\n")
    if fast5:
        for label, (i, read, qual) in fastqs.items():
            fastq = f"@{label}\n{read.template_read}\n+\n{qual}\n"
            comp = None
            if complements is not None:     # the decoys copy read 0
                comp = complements[i if i < len(rgs) else 0]
            _write_fast5(os.path.join(paths["fast5_dir"], f"{label}.fast5"),
                         label, i, read, fastq, events=not raw,
                         signal=raw or signal, noise=noise, complement=comp)
    if motifs:
        paths["positions"] = make_positions_file(
            paths["fasta"], os.path.join(out_dir, "positions.tsv"), motifs)
    if model is not None:
        paths["model"] = os.path.join(out_dir, "template.model")
        model.write(paths["model"])
    return paths


def outlier_segments(model: PoreModel) -> List[Tuple[str, np.ndarray]]:
    """(sequence, events) of four segments that test the residual guard
    of the probability-space sweeps (seed 7): a random sequence of 300
    bases; per k-mer one event drawn from its level, then stays (each
    with probability 0.3) drawn with 3x its level sd. In segments 0 and 2
    the events 101-179 are replaced by the level of a random k-mer + 30
    pA: a run that no path explains, which spreads the band's log values
    past the ~157 nats an f32 probability can hold (its totals come out
    NaN), while the log-space DP aligns it. Events: (mean, noise,
    duration, start) columns."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(4):
        seq = "".join(rng.choice(list(BASES), size=300))
        means = []
        for kid in model.alphabet.seq_to_kmer_ids(seq):
            mu, sd = model.level_mean[kid], model.level_sd[kid]
            means.append(mu + rng.normal(0, sd))
            while rng.random() < 0.3:
                means.append(mu + rng.normal(0, 3 * sd))
        means = np.array(means)
        bad = rng.integers(0, model.num_kmers, 79)
        if i % 2 == 0:
            means[101:180] = model.level_mean[bad] + 30.0
        m = len(means)
        out.append((seq, np.stack([means, np.ones(m), np.full(m, .005),
                                   np.arange(m) * .005], 1)))
    return out
