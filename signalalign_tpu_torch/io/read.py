"""In-memory nanopore read containers and their fast5 readers, 1D and 2D:
the port's copy of ``signalalign_tpu.io.read`` (the reference's
NanoporeRead and NanoporeRead2D, src/signalalign/nanoporeRead.py +
impl/nanopore.c, without the .npRead file round-trip).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from signalalign_tpu_torch.io.fast5 import Fast5
from signalalign_tpu_torch.models.pore_model import ScalingParams


def make_event_map(moves: np.ndarray, p_model_state: np.ndarray,
                   n_bases: int, kmer_length: int,
                   strict: bool = True) -> np.ndarray:
    """Per-base index of the event whose model_state covers that base.

    reference: NanoporeRead.make_event_map (nanoporeRead.py:314-333): walk
    events; move==1 appends the event, move>m repeats the previous event for
    skipped bases then appends, move==0 replaces the last entry if its
    p_model_state improves. The map is padded with the final event for the
    trailing k-1 bases and has exactly one entry per read base.
    """
    event_map = [0]
    previous_prob = 0.0
    for i in range(1, len(moves)):
        move = int(moves[i])
        this_prob = float(p_model_state[i])
        if move == 1:
            event_map.append(i)
        elif move > 1:
            for _ in range(move - 1):
                event_map.append(i - 1)
            event_map.append(i)
        elif move == 0:
            if this_prob > previous_prob:
                event_map[-1] = i
        previous_prob = this_prob
    event_map.extend([event_map[-1]] * (kmer_length - 1))
    out = np.asarray(event_map, dtype=np.int64)
    if len(out) != n_bases:
        if not strict and len(out) < n_bases:
            # generated (kmer-event-aligned) tables may leave the trailing
            # bases unaligned after band trimming; repeat the final event
            out = np.concatenate([out, np.full(n_bases - len(out),
                                               out[-1], dtype=np.int64)])
        elif not strict:
            out = out[:n_bases]
        else:
            raise ValueError(
                f"event map length {len(out)} != read length {n_bases}")
    return out


def sequence_from_events(model_states: np.ndarray, moves: np.ndarray) -> str:
    """Reconstruct the read from an event table.

    reference: NanoporeRead.sequence_from_events (nanoporeRead.py:348-360).
    """
    bases: List[str] = []
    for i in range(len(moves)):
        state = model_states[i]
        state = state.decode() if isinstance(state, bytes) else str(state)
        if i == 0:
            bases.extend(state)
        else:
            move = int(moves[i])
            if move > 0:
                bases.append(state[-move:])
    return "".join(bases)


def mean_fastq_quality(fastq: str) -> float:
    lines = fastq.strip("\n").split("\n")
    if len(lines) < 4:
        return 0.0
    quals = np.frombuffer(lines[3].encode("latin-1"), dtype=np.uint8)
    return float(np.mean(quals - 33)) if len(quals) else 0.0


@dataclasses.dataclass
class NanoporeReadData:
    """Everything the aligner needs for one 1D read strand."""
    read_label: str
    template_read: str                 # RNA reads already reversed + U->T
    events: np.ndarray                 # (n, 4): mean, stdv, length, start-start0
    event_map: np.ndarray              # (len(template_read),) event index per base
    model_states: Optional[np.ndarray]  # per-event kmer strings (bytes)
    p_model_state: Optional[np.ndarray]
    kmer_length: int
    params: ScalingParams
    rna: bool = False
    fastq: Optional[str] = None
    fast5_path: Optional[str] = None
    # 2D strands: scaling-parameter estimation runs on the 1D strand read +
    # strand event map even when the DP query is the 2D alignment-table
    # sequence (signalUtils_templateOneDAssignmentsFromRead,
    # signalMachineUtils.c:172-184)
    assign_read: Optional[str] = None
    assign_event_map: Optional[np.ndarray] = None
    analysis_path: Optional[str] = None   # fast5 analysis the events came from

    @property
    def n_events(self) -> int:
        return len(self.events)

    @property
    def read_length(self) -> int:
        return len(self.template_read)

    @classmethod
    def from_fast5(cls, path: str, quality_threshold: Optional[float] = 7.0
                   ) -> "NanoporeReadData":
        """Load from an already-basecalled fast5.

        Mirrors NanoporeRead._initialize (nanoporeRead.py:180-278): find the
        newest basecall analysis with events, read fastq (quality filter),
        apply RNA transforms, build the strand event map.
        """
        with Fast5(path) as f5:
            rna = f5.is_rna()
            analysis = f5.latest_analysis()
            if analysis is None:
                raise ValueError(f"{path}: no basecall events; run kmer-event "
                                 "alignment first (pipeline.event_align)")
            events = f5.template_events(analysis)
            if rna and events is not None and \
                    np.issubdtype(events["start"].dtype, np.integer):
                # RNA basecall tables in index scale are unusable
                # (has_valid_event_table_format, nanoporeRead.py:298-311);
                # the reference regenerates them with kmer-event alignment.
                # Prefer an already-embedded re-segmented table.
                resegment = f5.latest_analysis("ReSegmentBasecall")
                if resegment is None:
                    raise ValueError(
                        f"{path}: RNA basecall events are index-scale; run "
                        "kmer-event alignment first (pipeline.event_align)")
                analysis = resegment
                events = f5.template_events(analysis)
            fastq = f5.template_fastq(analysis)
            if fastq is None:
                raise ValueError(f"{path}: basecall analysis missing fastq")
            qual_line = fastq.split("\n")[3] if fastq.count("\n") >= 3 else ""
            if quality_threshold is not None and \
                    qual_line.strip("!"):  # all-'!' = placeholder qualities
                q = mean_fastq_quality(fastq)
                if q < quality_threshold:
                    raise ValueError(f"{path}: mean fastq quality {q:.2f} < "
                                     f"{quality_threshold}")
            read = fastq.split("\n")[1]
            if rna:
                read = read.replace("U", "T")[::-1]

            kmer_length = len(events["model_state"][0]) if len(events) else 0
            if kmer_length <= 0 or len(read) == 0:
                raise ValueError(f"{path}: empty events or read")

            event_map = make_event_map(events["move"], events["p_model_state"],
                                       len(read), kmer_length)

            start0 = float(events["start"][0])
            ev = np.stack([
                np.asarray(events["mean"], dtype=np.float64),
                np.asarray(events["stdv"], dtype=np.float64),
                np.asarray(events["length"], dtype=np.float64),
                np.asarray(events["start"], dtype=np.float64) - start0,
            ], axis=1)

            model_attrs = f5.template_model_attrs(analysis)
            params = ScalingParams()
            if model_attrs:
                for k, v in model_attrs.items():
                    setattr(params, k, v)

            return cls(
                read_label=f5.read_id or path,
                template_read=read,
                events=ev,
                event_map=event_map,
                model_states=np.asarray(events["model_state"]),
                p_model_state=np.asarray(events["p_model_state"], dtype=np.float64),
                kmer_length=kmer_length,
                params=params,
                rna=rna,
                fastq=fastq,
                fast5_path=path,
                analysis_path=analysis,
            )


def assemble_2d_sequence(kmers: List[str]) -> str:
    """2D read sequence from the Basecall_2D alignment-table k-mer column.

    reference: NanoporeRead2D.assemble_2d_sequence_from_table
    (nanoporeRead.py:693-728): consecutive distinct k-mers are merged by
    their maximal suffix/prefix overlap so every position has an event map.
    """
    seq = kmers[0]
    p_kmer = kmers[0]
    k = len(p_kmer)
    for kmer in kmers:
        if kmer == p_kmer:
            continue
        i = k
        for x in range(1, k):
            if p_kmer[x:] == kmer[:-x]:
                i = x
                break
        seq += kmer[-i:]
        p_kmer = kmer
    return seq


def make_twod_event_maps(table_t: np.ndarray, table_c: np.ndarray,
                         kmers: List[str], seq: str, k: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-base maps of the 2D sequence onto template/complement events.

    reference: NanoporeRead2D.get_twoD_event_map (nanoporeRead.py:731-832):
    walk the 2D sequence k-mers against the alignment table (skipping
    repeated table k-mers); template gaps back-fill with the next aligned
    event, complement gaps carry the previous event; sequence k-mers not in
    the table carry the previous events; the trailing k-1 bases repeat the
    final events. Both maps have one entry per 2D-sequence base.
    """
    t_map: List[int] = []
    c_map: List[int] = []
    row = 0
    prev_kmer = ""
    nb_t_gaps = 0
    prev_c = 0
    prev_t = 0
    n_rows = len(kmers)
    for i in range(len(seq) - k + 1):
        seq_kmer = seq[i:i + k]
        cur = kmers[row] if row < n_rows else None
        while cur is not None and cur == prev_kmer:
            row += 1
            cur = kmers[row] if row < n_rows else None
        if cur is not None and seq_kmer == cur:
            t_ev = int(table_t[row])
            c_ev = int(table_c[row])
            if t_ev == -1:
                nb_t_gaps += 1
            else:
                t_map += [t_ev] * (nb_t_gaps + 1)
                nb_t_gaps = 0
                prev_t = t_ev
            if c_ev == -1:
                c_map.append(prev_c)
            else:
                c_map.append(c_ev)
                prev_c = c_ev
            prev_kmer = cur
            row += 1
        else:
            t_map.append(prev_t)
            c_map.append(prev_c)
    for _ in range(k - 1):
        t_map += [prev_t] * (nb_t_gaps + 1)
        nb_t_gaps = 0
        c_map.append(prev_c)
    return (np.asarray(t_map[:len(seq)], dtype=np.int64),
            np.asarray(c_map[:len(seq)], dtype=np.int64))


@dataclasses.dataclass
class NanoporeRead2DData:
    """Both strands of a 2D read, DP-ready.

    ``template``/``complement`` are NanoporeReadData whose query sequence is
    the 2D alignment-table sequence and whose event maps are the 2D maps
    (complement map stored REVERSED so it ascends with 2D position, matching
    the serialized .npRead consumed by signalMachine, nanoporeRead.py
    Write line 9).
    """
    read_label: str
    twod_sequence: str
    kmer_length: int
    template: NanoporeReadData
    complement: NanoporeReadData

    @classmethod
    def from_fast5(cls, path: str) -> "NanoporeRead2DData":
        """reference: NanoporeRead2D._initialize (nanoporeRead.py:596-691):
        the newest Basecall_2D alignment table and the newest Basecall_1D
        analysis's strand events, Fastq and Model attributes, through
        ``from_tables``."""
        with Fast5(path) as f5:
            fh = f5.fh
            twod = None
            if "Analyses" in fh:
                for name in sorted(fh["Analyses"]):
                    if name.startswith("Basecall_2D_") and \
                            f"Analyses/{name}/BaseCalled_2D/Alignment" in fh:
                        twod = f"Analyses/{name}"
            if twod is None:
                raise ValueError(f"{path}: no Basecall_2D alignment table")
            table = np.asarray(fh[f"{twod}/BaseCalled_2D/Alignment"][()])
            oned = f5.latest_analysis("Basecall_1D") or twod
            strands = {}
            for name in ("template", "complement"):
                addr = f"{oned}/BaseCalled_{name}/Events"
                if addr not in fh:
                    raise ValueError(f"{path}: missing {addr}")
                events = np.asarray(fh[addr][()])
                fastq_addr = f"{oned}/BaseCalled_{name}/Fastq"
                fastq = _decode_bytes(fh[fastq_addr][()]) \
                    if fastq_addr in fh else None
                model_addr = f"{oned}/BaseCalled_{name}/Model"
                attrs = {}
                if model_addr in fh:
                    attrs = {key: float(fh[model_addr].attrs[key])
                             for key in ("scale", "shift", "drift", "var",
                                         "scale_sd", "var_sd")
                             if key in fh[model_addr].attrs}
                strands[name] = (events, fastq, attrs)
            return cls.from_tables(f5.read_id or path, table, strands, path)

    @classmethod
    def from_tables(cls, read_label: str, table: np.ndarray, strands: dict,
                    fast5_path: Optional[str] = None) -> "NanoporeRead2DData":
        """Both strands from the tables a 2D fast5 holds: the 2D alignment
        ``table`` (template, complement, kmer) and, per strand name,
        (basecall event table, Fastq or None, Model attributes)."""
        kmers = [v.decode() if isinstance(v, bytes) else str(v)
                 for v in table["kmer"]]
        k = len(kmers[0])
        seq = assemble_2d_sequence(kmers)
        t_map, c_map = make_twod_event_maps(
            table["template"], table["complement"], kmers, seq, k)

        out = {}
        for name, ev_map in (("template", t_map), ("complement", c_map)):
            events, fastq, attrs = strands[name]
            strand_read = fastq.split("\n")[1] if fastq else None
            pms = np.asarray(
                events["p_model_state"]
                if "p_model_state" in events.dtype.names
                else events["weights"], dtype=np.float64)
            strand_map = None
            if strand_read is not None:
                strand_map = make_event_map(
                    events["move"], pms, len(strand_read), k)
            start0 = float(events["start"][0])
            ev = np.stack([
                np.asarray(events["mean"], dtype=np.float64),
                np.asarray(events["stdv"], dtype=np.float64),
                np.asarray(events["length"], dtype=np.float64),
                np.asarray(events["start"], dtype=np.float64) - start0,
            ], axis=1)
            params = ScalingParams()
            for key, value in attrs.items():
                setattr(params, key, value)
            use_map = ev_map if name == "template" else ev_map[::-1].copy()
            out[name] = NanoporeReadData(
                read_label=read_label,
                template_read=seq,
                events=ev,
                event_map=use_map,
                model_states=np.asarray(events["model_state"]),
                p_model_state=pms,
                kmer_length=k,
                params=params,
                fastq=fastq,
                fast5_path=fast5_path,
                assign_read=strand_read,
                assign_event_map=strand_map,
            )
        return cls(
            read_label=read_label,
            twod_sequence=seq, kmer_length=k,
            template=out["template"],
            complement=out["complement"])


def _decode_bytes(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)
