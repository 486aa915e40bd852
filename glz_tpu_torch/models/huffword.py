"""HuffWord codec: word-based canonical Huffman with dual dictionaries, in
the bitstream layout (layout 0) and the lockstep layout (layout 2).

Tokens strictly alternate between a word and a non-word dictionary; each
dictionary gets its own canonical code, ids are (length, content) ranks,
and the container stores both dictionaries' code lengths and token text
(the codebook section, huffword_cb_blob).  Token parity selects the
dictionary.  Containers are byte-identical to the JAX package's for the
same input and configuration.

Lockstep: a stream holds S tokens with S even, so token parity is step
parity and the decoder swaps dictionaries per step.  Compress: tokenize and
build the vocabularies on the host; on the card, gather each token's lj|len
entry word (K6), the entry-word lane totals and the reverse-sweep encode
(K4).  Decompress: on the card, the dual-codebook decode (K5) and the rank
-> id gather (K6); detokenize on the host.  The whole input is encoded in
one launch per kernel: the container does not depend on how the input is
split into launches, because every split is a whole number of groups.

Bitstream: streams of up to 2^14 tokens, one MSB-first bit stream whose
last partial byte is padded with 1s.  Compress: on the card, K6 gathers
each token's left-justified code and then its length (two launches: codes
of 27-32 bits rule out the fused lj|len word) and the bit pack (its scan
and its pack).  Decompress: the dual stream decode (a stream starts at the parity of
its first token, odd when S is odd) and K6's rank -> id gather.  The JAX
package writes this layout on the host; the port runs the same codec on the
card.  All kernel index math is 64-bit.

The front door (core/api.py) picks the layout: lockstep when backend is
"device" or conf.layout is lockstep, as the JAX package's compress_huffword
does.

The steps are spans of utils/timer.py, as in canonical_byte.py (`vocab` and
`detokenize` in utils/tokenizer.py), and the host copies count their bytes
as `host_copy_bytes`; every copy between host and card goes through
models/transfer.py.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import bitio, container, lockstep
from glz_tpu_torch.core.codebook import Codebook, build_codebook, canonical_codebook
from glz_tpu_torch.models import transfer
from glz_tpu_torch.models.canonical_byte import group_tables, stream_starts
from glz_tpu_torch.ops.decode import decode_streams_dual
from glz_tpu_torch.ops.encode import pack_codes
from glz_tpu_torch.ops.lockstep_decode import decode_groups_dual
from glz_tpu_torch.ops.lockstep_encode import encode_payload_from_entries
from glz_tpu_torch.ops.lut import gather_entries, map_ranks
from glz_tpu_torch.utils import timer
from glz_tpu_torch.utils import tokenizer as tok


# ---- the codebook section of a container ----------------------------------

def _encode_dict_blob(vocab: tok.TokenVocab, lengths: np.ndarray) -> bytes:
    n = vocab.n
    tok_lens = np.diff(vocab.offsets).astype("<u4")
    return (struct.pack("<I", n)
            + lengths.astype(np.uint8).tobytes()
            + tok_lens.tobytes()
            + vocab.blob)


def _corrupt(what: str):
    raise ValueError(f"corrupt .glz container: huffword codebook blob {what}")


def decode_dict_blob(mv: memoryview, off: int):
    """Parse one dictionary's (lengths, token-length, token-text) section.

    Every count is validated against the blob size before use, so a corrupt
    or truncated container fails with a clean ValueError."""
    if len(mv) - off < 4:
        _corrupt("truncated before dictionary size")
    (n,) = struct.unpack_from("<I", mv, off)
    off += 4
    if 5 * n > len(mv) - off:
        _corrupt(f"claims {n} tokens but only {len(mv) - off} bytes remain")
    lengths = np.frombuffer(mv, dtype=np.uint8, count=n, offset=off).astype(np.int32)
    off += n
    if int(lengths.max(initial=0)) > 32:
        _corrupt("has a code length > 32")
    tok_lens = np.frombuffer(mv, dtype="<u4", count=n, offset=off).astype(np.int64)
    off += 4 * n
    total = int(tok_lens.sum())
    if total > len(mv) - off:
        _corrupt(f"token text claims {total} bytes but only "
                 f"{len(mv) - off} remain")
    blob = bytes(mv[off : off + total])
    off += total
    offsets = np.concatenate([[0], np.cumsum(tok_lens)])
    return lengths, offsets, blob, off


def huffword_cb_blob(word_first: bool, wv, nv, cbs) -> bytes:
    """The codebook section of a container (a `container.write` span)."""
    with timer.span("container.write"):
        blob = (struct.pack("<B", 1 if word_first else 0)
                + _encode_dict_blob(wv, cbs[0].lengths if wv.n else np.zeros(0))
                + _encode_dict_blob(nv, cbs[1].lengths if nv.n else np.zeros(0)))
        timer.count(timer.HOST_COPY_BYTES, len(blob))
        return blob


def huffword_state_from_blob(codebook_blob: bytes):
    """A container's codebook section -> (word_first, cb_word, cb_nonword,
    word_vocab, nonword_vocab): the whole state of a HuffWord codec.  The
    vocabularies carry token text and offsets; their counts are None (a
    container stores code lengths, not counts).  The parse is a
    `container.read` span, the codes a `codebook` one."""
    with timer.span("container.read"):
        mv = memoryview(codebook_blob)
        if len(mv) < 1:
            _corrupt("truncated before word_first")
        word_first = bool(mv[0])
        wl, woff, wblob, off = decode_dict_blob(mv, 1)
        nl, noff, nblob, off = decode_dict_blob(mv, off)
        timer.count(timer.HOST_COPY_BYTES, len(wblob) + len(nblob))
        wv = tok.TokenVocab.from_parts(wblob, np.diff(woff), None)
        nv = tok.TokenVocab.from_parts(nblob, np.diff(noff), None)
    with timer.span("codebook"):
        return word_first, canonical_codebook(wl), canonical_codebook(nl), wv, nv


# ---- compress ---------------------------------------------------------------

def encode_lockstep_tokens(ids: np.ndarray, T: int, word_first: bool,
                           cbs: list[Codebook], n_word: int, n_nonword: int,
                           S: int, rows: int = 8, device=None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Class-local token ids -> (payload u32 np, padded group word counts
    np.int64).

    On the card: K6 gathers each token's fused lj|len entry word from its
    parity dictionary (0 past T), then the entry-word lane totals and K4
    write the consumption-order payload.  Streams hold S tokens with S even,
    so token parity == step parity."""
    dev = transfer.resolve_device(device)
    padded_T = transfer.round_up(max(T, 1), rows * lockstep.LANES * S)
    n0 = max(n_word, 1)
    with timer.span("tables"):
        ent_tbls = [cb.left_justified_codes() | cb.lengths.astype(np.uint32)
                    for cb in cbs]
        combined_tbl = transfer.i32_tensor(np.concatenate(
            [ent_tbls[0] if n_word else np.zeros(1, np.uint32),
             ent_tbls[1] if n_nonword else np.zeros(1, np.uint32)]), dev)
    small = max(n_word, n_nonword) <= 0xFFFF
    ids_d = transfer.ids_on(ids, T, padded_T, small, dev)
    with timer.span("encode"):
        ent = gather_entries(ids_d, combined_tbl, 0, n0, T, bool(word_first))
        del ids_d
        payload, group_counts = encode_payload_from_entries(ent, S, rows)
    with timer.span("d2h"):
        return transfer.host_array(payload).view(np.uint32), group_counts


def lockstep_container(data, conf: cfg.GlzConfig, word_first: bool, wv, nv,
                       ids: np.ndarray, cbs: list[Codebook], S: int, rows: int,
                       device=None) -> bytes:
    """The layout-2 HuffWord container of class-local token ids,
    vocabularies and codebooks (code lengths <= 26), S tokens a stream in
    groups of `rows` rows (shared by the compress and the shared-codebook
    batch)."""
    T = ids.size
    payload, group_counts = encode_lockstep_tokens(
        ids, T, word_first, cbs, wv.n, nv.n, S, rows=rows, device=device)
    return container.write_container(container.GlzFile(
        mode=cfg.MODE_HUFFWORD,
        n_symbols=T,
        stream_symbols=S,
        stream_bits=group_counts,
        codebook_blob=huffword_cb_blob(word_first, wv, nv, cbs),
        payload=transfer.words_buffer(payload),
        layout=container.LAYOUT_LOCKSTEP,
        checksum=container.checksum_of(data, conf),
        group_rows=rows,
    ))


def _compress_huffword_device(data, conf: cfg.GlzConfig, word_first: bool,
                              wv, nv, ids, device=None) -> bytes:
    """The HuffWord lockstep container of tokenized data (conf.group_rows
    checked by lockstep.group_rows)."""
    S = lockstep.huffword_stream_tokens(conf)
    rows = lockstep.capped_rows(conf.group_rows, S, max(wv.n, nv.n) <= 0xFFFF)
    limit = lockstep.fused_length_limit(conf)
    with timer.span("codebook"):
        cbs = [build_codebook(wv.counts, limit), build_codebook(nv.counts, limit)]
    return lockstep_container(data, conf, word_first, wv, nv, ids, cbs, S, rows, device)


def compress_huffword_lockstep(data: bytes | np.ndarray, conf: cfg.GlzConfig = cfg.DEFAULT,
                               device=None) -> bytes:
    """HuffWord compression into the lockstep layout, on the card
    (device=None) or, with device='cpu', through the kernels' plain
    versions: glz_tpu's compress_huffword container when its backend is
    "device" or conf.layout is lockstep.  Code lengths are capped at 26 (the
    fused lj|len entry word); conf.stream_symbols of a byte preset selects
    512 tokens per stream, and group_rows is capped by
    lockstep.huffword_rows_cap with a warning."""
    lockstep.group_rows(conf)
    dev = transfer.resolve_device(device)
    _, _, word_first, wv, nv, ids = tok.build_vocabs(data)
    return _compress_huffword_device(data, conf, word_first, wv, nv, ids, dev)


def bitstream_tables(cbs: list[Codebook], n_word: int, n_nonword: int,
                     dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lj, length) int32 tables of the two dictionaries concatenated, the
    word dictionary's first (one zero entry for an empty dictionary)."""
    def table(column) -> torch.Tensor:
        return transfer.i32_tensor(np.concatenate(
            [column(cbs[0]) if n_word else np.zeros(1, np.uint32),
             column(cbs[1]) if n_nonword else np.zeros(1, np.uint32)]), dev)

    with timer.span("tables"):
        return (table(Codebook.left_justified_codes),
                table(lambda cb: cb.lengths.astype(np.uint32)))


def encode_bitstream_tokens(ids: np.ndarray, T: int, word_first: bool,
                            cbs: list[Codebook], n_word: int, n_nonword: int,
                            stream_tokens: int, n_streams: int, device=None
                            ) -> tuple[bytes, np.ndarray]:
    """Class-local token ids (T >= 1) -> (payload bytes, stream_bits np.int64
    [n_streams]) of a layout-0 container.

    On the card: K6 gathers each token's left-justified code, then its
    length, from its parity dictionary (0 past T); the bit pack (its scan
    and its pack) follows.  The payload is the words' big-endian
    bytes up to the last code bit, the last partial byte padded with 1s."""
    dev = transfer.resolve_device(device)
    small = max(n_word, n_nonword) <= 0xFFFF
    ids_d = transfer.ids_on(ids, T, n_streams * stream_tokens, small, dev)
    n0 = max(n_word, 1)
    lj_tbl, len_tbl = bitstream_tables(cbs, n_word, n_nonword, dev)
    with timer.span("encode"):
        lj = gather_entries(ids_d, lj_tbl, 0, n0, T, bool(word_first))
        lens = gather_entries(ids_d, len_tbl, 0, n0, T, bool(word_first))
        del ids_d
        words, total_bits, stream_bits = pack_codes(lj, lens, stream_tokens)
    with timer.span("d2h"):
        words, stream_bits = transfer.host_array(words), stream_bits.cpu().numpy()
    with timer.span("serialize"):
        payload = bitio.words_to_bytes(words.view(np.uint32), total_bits)
    return payload, stream_bits


def bitstream_container(data, conf: cfg.GlzConfig, word_first: bool, wv, nv,
                        ids: np.ndarray, cbs: list[Codebook], device=None) -> bytes:
    """The layout-0 HuffWord container of class-local token ids, vocabularies
    and codebooks (shared by the compress and the shared-codebook batch).
    Streams hold min(stream_symbols, 2^14) tokens, more when
    conf.max_streams would be exceeded."""
    T = ids.size
    stream_tokens = min(conf.stream_symbols, 1 << 14)
    n_streams = max(1, -(-T // stream_tokens)) if T else 1
    if n_streams > conf.max_streams:
        stream_tokens = -(-T // conf.max_streams)
        n_streams = -(-T // stream_tokens)
    if T:
        payload, stream_bits = encode_bitstream_tokens(
            ids, T, word_first, cbs, wv.n, nv.n, stream_tokens, n_streams, device)
    else:
        payload, stream_bits = b"", np.zeros(1, np.int64)
    return container.write_container(container.GlzFile(
        mode=cfg.MODE_HUFFWORD,
        n_symbols=T,
        stream_symbols=stream_tokens,
        stream_bits=stream_bits.astype(np.uint64),
        codebook_blob=huffword_cb_blob(word_first, wv, nv, cbs),
        payload=payload,
        checksum=container.checksum_of(data, conf),
    ))


def compress_huffword_bitstream(data: bytes | np.ndarray, conf: cfg.GlzConfig = cfg.DEFAULT,
                                device=None) -> bytes:
    """HuffWord compression into the bitstream layout, on the card
    (device=None) or, with device='cpu', through the kernels' plain
    versions: glz_tpu's compress_huffword container under its backend
    "host" and a bitstream conf.  Code lengths are capped at
    conf.length_limit (up to 32)."""
    dev = transfer.resolve_device(device)
    _, _, word_first, wv, nv, ids = tok.build_vocabs(data)
    with timer.span("codebook"):
        cbs = [build_codebook(v.counts if v.n else np.zeros(1, np.int64), conf.length_limit)
               for v in (wv, nv)]
    return bitstream_container(data, conf, word_first, wv, nv, ids, cbs, dev)


# ---- decompress -------------------------------------------------------------

def _ranks_to_ids(ranks: torch.Tensor, cb_even: Codebook, cb_odd: Codebook, small: bool,
                  T: int, dev: torch.device) -> np.ndarray:
    """Canonical ranks in file order -> token ids np.int64 [T]: K6 on the
    card, then D2H as u16 when the vocabularies fit (`small`: 2 bytes per
    token instead of 4)."""
    n_even = max(cb_even.symbols.size, 1)
    with timer.span("tables"):
        sym_cat = transfer.i32_tensor(np.concatenate(
            [cb_even.symbols if cb_even.symbols.size else np.zeros(1, np.uint32),
             cb_odd.symbols if cb_odd.symbols.size else np.zeros(1, np.uint32)]), dev)
    with timer.span("decode"):
        ids = map_ranks(ranks, sym_cat, n_even, small)
        del ranks
    with timer.span("d2h"):
        ids = transfer.host_array(ids[:T]).view(np.uint16 if small else np.uint32)
    with timer.span("serialize"):
        ids = ids.astype(np.int64)
        timer.count(timer.HOST_COPY_BYTES, ids.nbytes)
        return ids


def _dual_tables(cb_even: Codebook, cb_odd: Codebook, dev: torch.device):
    """(fc_lj, offsets) int32 [2, 34] tensors of the dual decodes, row 0 the
    even tokens' codebook."""
    with timer.span("tables"):
        fc = np.stack([cb_even.first_code_left_justified(),
                       cb_odd.first_code_left_justified()])
        offsets = np.stack([cb_even.decode_offsets(), cb_odd.decode_offsets()])
        return transfer.i32_tensor(fc, dev), transfer.i32_tensor(offsets, dev)


def _decompress_huffword_device(f: container.GlzFile, dev: torch.device, variant: str):
    """Decode a HuffWord container's tokens on the card: the lockstep dual
    decode (K5) or the bitstream dual stream decode of the decoder strategy
    `variant` ("table", "bitwalk" or "fast"), then K6.  Returns (ids
    np.int64 [T], word_first, word_vocab, nonword_vocab); detokenizing
    happens upstream."""
    word_first, cb_w, cb_n, wv, nv = huffword_state_from_blob(f.codebook_blob)
    # dictionary of token i: the first one when (i even) == word_first
    cb_even, cb_odd = (cb_w, cb_n) if word_first else (cb_n, cb_w)
    fc, offsets = _dual_tables(cb_even, cb_odd, dev)
    lens = (cb_even.min_len, cb_odd.min_len), (cb_even.max_len, cb_odd.max_len)

    T = f.n_symbols
    S = f.stream_symbols
    if f.layout == container.LAYOUT_LOCKSTEP:
        G = lockstep.group_streams(f)
        starts, counts = group_tables(f.stream_bits, T, G, S, dev)
        payload = transfer.payload_words_on(f.payload, dev)
        with timer.span("decode"):
            ranks = decode_groups_dual(payload, starts, counts, fc, offsets, S, *lens,
                                       f.group_rows)
    else:
        starts = stream_starts(f, dev)
        payload = transfer.payload_words_on(transfer.bitstream_words(f.payload), dev)
        with timer.span("decode"):
            ranks = decode_streams_dual(payload, starts, T, S, fc, offsets, *lens,
                                        variant=variant,
                                        n_codes=(cb_even.symbols.size, cb_odd.symbols.size))
    small = max(wv.n, nv.n) <= 0xFFFF
    return _ranks_to_ids(ranks, cb_even, cb_odd, small, T, dev), word_first, wv, nv


def decompress_huffword(f: container.GlzFile, device=None,
                        variant: str = cfg.DECODER_TABLE) -> bytes:
    """Decode a parsed HuffWord container of either layout (on the card,
    then detokenize on the host); `variant` ("table", "bitwalk" or "fast")
    picks a bitstream container's decoder strategy."""
    dev = transfer.resolve_device(device)
    if f.n_symbols == 0:
        return b"" if f.layout == container.LAYOUT_LOCKSTEP else container.verify(b"", f)
    ids, word_first, wv, nv = _decompress_huffword_device(f, dev, variant)
    return container.verify(tok.detokenize(ids, word_first, wv, nv), f)
