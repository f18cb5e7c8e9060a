"""Minimal pure-Python SAM/BAM reading (pysam is not a dependency): the
port's copy of ``signalalign_tpu.io.sam`` (same parsing, same order).

BAM is BGZF (concatenated gzip members — Python's gzip handles these) over a
simple binary record stream. We parse only the fields the pipeline needs:
name, flag, reference, position, mapq, CIGAR, sequence, qualities.

Also: .readdb parsing (read_id -> fast5 path) and the read filter used by
the reference (filter_reads, src/signalalign/filter_reads.py:144: primary,
mapped, mean phred >= threshold).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
SEQ_CODES = "=ACMGRSVTWYHKDBN"

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800
# qname suffixes build_readdb aliases to a fast5's read id
READ_ID_SUFFIXES = ("", "_Basecall_1D_template", "_Basecall_2D_template",
                    "_Basecall_Alignment_template:1D_000:template")


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: Optional[str]
    pos: int                     # 0-based leftmost
    mapq: int
    cigar: List[Tuple[int, str]]  # (length, op)
    seq: str
    qual: Optional[np.ndarray]   # phred values
    tags: Optional[Dict[str, object]] = None

    @property
    def is_mapped(self) -> bool:
        return not (self.flag & FLAG_UNMAPPED) and self.rname is not None

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_primary(self) -> bool:
        return not (self.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY))

    @property
    def mean_quality(self) -> float:
        if self.qual is None or len(self.qual) == 0:
            return 0.0
        return float(np.mean(self.qual))

    def cigar_string(self) -> str:
        return "".join(f"{l}{op}" for l, op in self.cigar)

    def reference_span(self) -> int:
        return sum(l for l, op in self.cigar if op in "MDN=X")


def _parse_tags(data: bytes, p: int, end: int) -> Dict[str, object]:
    tags: Dict[str, object] = {}
    sizes = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
    fmts = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I", "f": "<f"}
    while p + 3 <= end:
        tag = data[p:p + 2].decode()
        typ = chr(data[p + 2])
        p += 3
        if typ == "Z":
            q = data.index(b"\x00", p)
            tags[tag] = data[p:q].decode()
            p = q + 1
        elif typ == "A":
            tags[tag] = chr(data[p])
            p += 1
        elif typ in sizes:
            tags[tag] = struct.unpack_from(fmts[typ], data, p)[0]
            p += sizes[typ]
        elif typ == "B":
            st = chr(data[p])
            n = struct.unpack_from("<I", data, p + 1)[0]
            p += 5 + n * sizes[st]
        else:
            break
    return tags


def reconstruct_reference_window(rec: SamRecord) -> Optional[str]:
    """Rebuild the aligned reference subsequence from SEQ + CIGAR + MD tag.

    Returns the forward-strand reference sequence covering
    [rec.pos, rec.pos + reference_span()), or None without an MD tag.
    """
    md = (rec.tags or {}).get("MD")
    if md is None:
        return None
    # aligned reference with deletions, mismatches still as read bases
    ref_chars: List[str] = []
    qpos = 0
    for length, op in rec.cigar:
        if op in "SH":
            if op == "S":
                qpos += length
        elif op in "M=X":
            ref_chars.extend(rec.seq[qpos:qpos + length])
            qpos += length
        elif op == "I":
            qpos += length
        elif op in "DN":
            ref_chars.extend("?" * length)
    # apply MD: walk matches / mismatches / deletions
    out = ref_chars
    i = 0  # position in out among non-insertion ref bases
    num = ""
    j = 0
    md_i = 0
    while md_i < len(md):
        c = md[md_i]
        if c.isdigit():
            num += c
            md_i += 1
            continue
        if num:
            i += int(num)
            num = ""
        if c == "^":
            md_i += 1
            while md_i < len(md) and md[md_i].isalpha():
                out[i] = md[md_i]
                i += 1
                md_i += 1
        else:
            out[i] = c  # mismatch: MD holds the reference base
            i += 1
            md_i += 1
    return "".join(out)


def parse_cigar_string(s: str) -> List[Tuple[int, str]]:
    out = []
    num = ""
    for c in s:
        if c.isdigit():
            num += c
        else:
            out.append((int(num), c))
            num = ""
    return out


def read_bam(path: str) -> Tuple[List[str], Iterator[SamRecord]]:
    """Return (reference_names, record iterator)."""
    data = gzip.open(path, "rb").read()
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path} is not a BAM file")
    off = 4
    l_text = struct.unpack_from("<i", data, off)[0]
    off += 4 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 4
        refs.append(data[off:off + l_name - 1].decode())
        off += l_name + 4  # skip l_ref

    def records(start=off):
        o = start
        n = len(data)
        while o + 4 <= n:
            block_size = struct.unpack_from("<i", data, o)[0]
            o += 4
            end = o + block_size
            (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
             _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", data, o)
            p = o + 32
            qname = data[p:p + l_read_name - 1].decode()
            p += l_read_name
            cigar = []
            for _ in range(n_cigar):
                v = struct.unpack_from("<I", data, p)[0]
                cigar.append((v >> 4, CIGAR_OPS[v & 0xF]))
                p += 4
            nbytes = (l_seq + 1) // 2
            seq_chars = []
            for i in range(l_seq):
                b = data[p + i // 2]
                code = (b >> 4) if i % 2 == 0 else (b & 0xF)
                seq_chars.append(SEQ_CODES[code])
            p += nbytes
            qual = np.frombuffer(data[p:p + l_seq], dtype=np.uint8).copy()
            if l_seq and qual[0] == 0xFF:
                qual = None
            p += l_seq
            tags = _parse_tags(data, p, end)
            yield SamRecord(
                qname=qname, flag=flag,
                rname=refs[ref_id] if ref_id >= 0 else None,
                pos=pos, mapq=mapq, cigar=cigar,
                seq="".join(seq_chars), qual=qual, tags=tags)
            o = end

    return refs, records()


def read_sam(path: str) -> Tuple[List[str], Iterator[SamRecord]]:
    refs = []

    def records():
        with open(path) as fh:
            for line in fh:
                if line.startswith("@"):
                    if line.startswith("@SQ"):
                        for f in line.split("\t"):
                            if f.startswith("SN:"):
                                refs.append(f[3:].strip())
                    continue
                f = line.rstrip("\n").split("\t")
                qual = None
                if f[10] != "*":
                    qual = np.frombuffer(f[10].encode("latin-1"), dtype=np.uint8) - 33
                yield SamRecord(
                    qname=f[0], flag=int(f[1]),
                    rname=None if f[2] == "*" else f[2],
                    pos=int(f[3]) - 1, mapq=int(f[4]),
                    cigar=[] if f[5] == "*" else parse_cigar_string(f[5]),
                    seq=f[9], qual=qual)

    return refs, records()


def read_alignment_file(path: str):
    if path.endswith(".bam"):
        return read_bam(path)
    return read_sam(path)


def load_readdb(path: str, fast5_dirs: List[str]) -> Dict[str, str]:
    """read_id -> absolute fast5 path.

    reference: filter_reads.py parse of the `embed_main index` readdb format
    (read_id \t relative_fast5_path per line).
    """
    out = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) != 2:
                continue
            read_id, f5 = parts
            candidates = [f5] if os.path.isabs(f5) else []
            for d in [os.path.dirname(path)] + list(fast5_dirs):
                candidates.append(os.path.join(d, f5))
                candidates.append(os.path.join(d, os.path.basename(f5)))
            for cand in candidates:
                if os.path.exists(cand):
                    out[read_id] = os.path.abspath(cand)
                    break
    return out


def passes_filter(rec: SamRecord, quality_threshold: float = 7.0) -> bool:
    """filter_reads' test of one record: primary, mapped, and a mean SEQ
    quality of at least ``quality_threshold`` where qualities are given."""
    if not rec.is_mapped or not rec.is_primary:
        return False
    return rec.qual is None or rec.mean_quality >= quality_threshold


def filter_reads(alignment_file: str, readdb: Optional[str],
                 fast5_dirs: List[str],
                 quality_threshold: float = 7.0) -> List[Tuple[str, SamRecord]]:
    """(fast5_path, record) for primary mapped reads above quality threshold.

    reference: filter_reads (src/signalalign/filter_reads.py:144-198);
    with ``readdb=None`` the mapping is built by scanning the fast5s.
    """
    if readdb is None:
        id_to_f5 = build_readdb(fast5_dirs)
    else:
        id_to_f5 = load_readdb(readdb, fast5_dirs)
    _, records = read_alignment_file(alignment_file)
    out = []
    for rec in records:
        if not passes_filter(rec, quality_threshold):
            continue
        f5 = id_to_f5.get(rec.qname)
        if f5 is not None:
            out.append((f5, rec))
    return out


def build_readdb(fast5_dirs: List[str]) -> Dict[str, str]:
    """read_id -> fast5 path mapping built by opening the fast5s directly
    (a nanopolish-index readdb stand-in; the reference requires the user to
    run `nanopolish index`). The qname suffixes READ_ID_SUFFIXES are
    aliased so BAM query names resolve without the exact readdb the BAM
    was indexed with. A missing h5py raises; a file h5py cannot read is
    left out."""
    import glob as _glob

    from signalalign_tpu_torch.io.fast5 import Fast5

    mapping: Dict[str, str] = {}
    for d in fast5_dirs:
        for p in sorted(_glob.glob(os.path.join(d, "*.fast5"))):
            try:
                with Fast5(p) as f5:
                    rid = f5.read_id
            except ImportError:
                raise
            except Exception:
                continue
            if not rid:
                continue
            for suf in READ_ID_SUFFIXES:
                mapping.setdefault(rid + suf, p)
    return mapping
