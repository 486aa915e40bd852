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

backend="device" writes a lockstep container even under a bitstream conf,
as the JAX package's compress_huffword does.

The steps are spans of utils/timer.py, as in canonical_byte.py (`vocab` and
`detokenize` in utils/tokenizer.py), and the host copies count their bytes
as `host_copy_bytes`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from glz_tpu_torch import config as cfg
from glz_tpu_torch.core import bitio, container
from glz_tpu_torch.core.api import _pipelined, _verify
from glz_tpu_torch.core.codebook import Codebook, build_codebook, canonical_codebook
from glz_tpu_torch.core.lockstep import LANES
from glz_tpu_torch.models.canonical_byte import (_i32_tensor, _round_up, bitstream_words,
                                                 group_tables, host_array,
                                                 payload_words_on, resolve_device,
                                                 words_buffer)
from glz_tpu_torch.ops.decode import decode_streams_dual
from glz_tpu_torch.ops.encode import pack_codes
from glz_tpu_torch.ops.lockstep_decode import decode_groups_dual
from glz_tpu_torch.ops.lockstep_encode import MAX_FUSED_LEN, encode_payload_from_entries
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


def _decode_dict_blob(mv: memoryview, off: int):
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
        wl, woff, wblob, off = _decode_dict_blob(mv, 1)
        nl, noff, nblob, off = _decode_dict_blob(mv, off)
        timer.count(timer.HOST_COPY_BYTES, len(wblob) + len(nblob))
        wv = tok.TokenVocab.from_parts(wblob, np.diff(woff), None)
        nv = tok.TokenVocab.from_parts(nblob, np.diff(noff), None)
    with timer.span("codebook"):
        return word_first, canonical_codebook(wl), canonical_codebook(nl), wv, nv


# ---- geometry: stream tokens and group rows --------------------------------

# stream_symbols values of the byte-oriented presets: for huffword they mean
# "no token-count preference was expressed", not an explicit request.
_BYTE_PRESET_S = {cfg.DEFAULT.stream_symbols, cfg.THROUGHPUT.stream_symbols,
                  cfg.RATIO.stream_symbols}
_HUFFWORD_DEFAULT_S = 512


def huffword_rows_cap(S: int, pack2: bool) -> int:
    """The container's group_rows bound for the dual decode.  It comes from
    the JAX package's TPU kernel (its u32 rank output block, (S//2 with
    pack2 else S) * rows * 512 B, must stay <= 4 MiB), and it decides the
    container's group_rows, so both packages apply it."""
    return max(8, ((1 << 14) if pack2 else (1 << 13)) // S)


def _capped_rows(rows: int, S: int, pack2: bool) -> int:
    """Apply huffword_rows_cap, with a warning when it lowers the request."""
    cap = huffword_rows_cap(S, pack2)
    if rows > cap:
        import warnings
        warnings.warn(
            f"huffword lockstep group_rows={rows} exceeds the dual kernel's "
            f"VMEM budget at stream_symbols={S} "
            f"({'pack2' if pack2 else 'u32-rank'} path); using group_rows="
            f"{cap} — lower stream_symbols to use wider groups",
            stacklevel=3)
        rows = cap
    return rows


def _huffword_stream_tokens(conf: cfg.GlzConfig) -> int:
    """Tokens per lockstep stream, a power of two in [64, 1024].

    An explicitly configured stream_symbols outside that range raises;
    the byte presets' defaults carry no huffword intent and select 512."""
    S = conf.stream_symbols
    if S & (S - 1) == 0 and 64 <= S <= 1024:
        return S
    if S in _BYTE_PRESET_S:
        return _HUFFWORD_DEFAULT_S
    raise ValueError(
        f"huffword device layout needs stream_symbols a power of two in "
        f"[64, 1024], got {S}")


def _check_rows(conf: cfg.GlzConfig) -> int:
    """conf.group_rows, after checking that it is a supported group width."""
    rows = conf.group_rows
    if rows not in (8, 16, 32, 64):
        raise ValueError(f"group_rows must be 8, 16, 32 or 64, got {rows}")
    return rows


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
    dev = resolve_device(device)
    group_syms = rows * LANES * S
    padded_T = _round_up(max(T, 1), group_syms)
    n0 = max(n_word, 1)
    with timer.span("tables"):
        ent_tbls = [cb.left_justified_codes() | cb.lengths.astype(np.uint32)
                    for cb in cbs]
        combined_tbl = _i32_tensor(np.concatenate(
            [ent_tbls[0] if n_word else np.zeros(1, np.uint32),
             ent_tbls[1] if n_nonword else np.zeros(1, np.uint32)]), dev)
    small = max(n_word, n_nonword) <= 0xFFFF
    ids_d = _ids_on(ids, T, padded_T, small, dev)
    with timer.span("encode"):
        ent = gather_entries(ids_d, combined_tbl, 0, n0, T, bool(word_first))
        del ids_d
        payload, group_counts = encode_payload_from_entries(ent, S, rows)
    with timer.span("d2h"):
        return host_array(payload).view(np.uint32), group_counts


def _ids_on(ids: np.ndarray, T: int, padded: int, small: bool,
            dev: torch.device) -> torch.Tensor:
    """Token ids as u16 (`small`) or u32 bit patterns on `dev`, zero-padded
    to `padded`: the padded host copy (`pad`), then the copy to `dev`
    (`h2d`)."""
    with timer.span("pad"):
        ids_pad = np.zeros(padded, np.uint16 if small else np.uint32)
        ids_pad[:T] = ids.astype(ids_pad.dtype)
        timer.count(timer.HOST_COPY_BYTES, 2 * T * ids_pad.itemsize)
    with timer.span("h2d"):
        return torch.from_numpy(ids_pad.view(np.int16 if small else np.int32)).to(dev)


def _lockstep_container(data, conf: cfg.GlzConfig, T: int, S: int, rows: int,
                        group_counts: np.ndarray, cb_blob: bytes,
                        payload: np.ndarray) -> bytes:
    return container.write_container(container.GlzFile(
        mode=cfg.MODE_HUFFWORD,
        n_symbols=T,
        stream_symbols=S,
        stream_bits=group_counts,
        codebook_blob=cb_blob,
        payload=words_buffer(payload),
        layout=container.LAYOUT_LOCKSTEP,
        checksum=zlib.crc32(data) if conf.checksum else None,
        group_rows=rows,
    ))


def _compress_huffword_device(data, conf: cfg.GlzConfig, word_first: bool,
                              wv, nv, ids, device=None) -> bytes:
    """The HuffWord lockstep container of tokenized data (conf checked by
    _check_rows)."""
    T = ids.size
    S = _huffword_stream_tokens(conf)
    small = max(wv.n, nv.n) <= 0xFFFF
    rows = _capped_rows(conf.group_rows, S, small)
    limit = min(conf.length_limit or MAX_FUSED_LEN, MAX_FUSED_LEN)
    with timer.span("codebook"):
        cbs = [build_codebook(wv.counts, limit), build_codebook(nv.counts, limit)]
    payload, group_counts = encode_lockstep_tokens(
        ids, T, word_first, cbs, wv.n, nv.n, S, rows=rows, device=device)
    return _lockstep_container(data, conf, T, S, rows, group_counts,
                               huffword_cb_blob(word_first, wv, nv, cbs), payload)


def bitstream_tables(cbs: list[Codebook], n_word: int, n_nonword: int,
                     dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lj, length) int32 tables of the two dictionaries concatenated, the
    word dictionary's first (one zero entry for an empty dictionary)."""
    def table(column) -> torch.Tensor:
        return _i32_tensor(np.concatenate(
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
    dev = resolve_device(device)
    small = max(n_word, n_nonword) <= 0xFFFF
    ids_d = _ids_on(ids, T, n_streams * stream_tokens, small, dev)
    n0 = max(n_word, 1)
    lj_tbl, len_tbl = bitstream_tables(cbs, n_word, n_nonword, dev)
    with timer.span("encode"):
        lj = gather_entries(ids_d, lj_tbl, 0, n0, T, bool(word_first))
        lens = gather_entries(ids_d, len_tbl, 0, n0, T, bool(word_first))
        del ids_d
        words, total_bits, stream_bits = pack_codes(lj, lens, stream_tokens)
    with timer.span("d2h"):
        words, stream_bits = host_array(words), stream_bits.cpu().numpy()
    with timer.span("serialize"):
        payload = bitio.words_to_bytes(words.view(np.uint32), total_bits)
    return payload, stream_bits


def _bitstream_container(data, conf: cfg.GlzConfig, T: int, word_first: bool, wv, nv,
                         ids: np.ndarray, cbs: list[Codebook], device=None) -> bytes:
    """The layout-0 HuffWord container of class-local token ids, vocabularies
    and codebooks (shared by compress_huffword and the shared-codebook
    batch).  Streams hold min(stream_symbols, 2^14) tokens, more when
    conf.max_streams would be exceeded."""
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
        checksum=zlib.crc32(data) if conf.checksum else None,
    ))


def compress_huffword(data: bytes | np.ndarray, conf: cfg.GlzConfig = cfg.DEFAULT,
                      backend: str = "host", device=None) -> bytes:
    """HuffWord compression on the card (device=None) or, with
    device='cpu', through the kernels' plain versions, into the container
    glz_tpu's compress_huffword writes for the same arguments: lockstep when
    backend is "device" or conf.layout is lockstep, else bitstream.

    Lockstep: code lengths are capped at 26 (the fused lj|len entry word);
    conf.stream_symbols of a byte preset selects 512 tokens per stream, and
    group_rows is capped by huffword_rows_cap with a warning.  Bitstream:
    code lengths are capped at conf.length_limit (up to 32)."""
    lockstep = backend == "device" or conf.layout == cfg.LAYOUT_LOCKSTEP
    if lockstep:
        _check_rows(conf)
    dev = resolve_device(device)
    _, _, word_first, wv, nv, ids = tok.build_vocabs(data)
    if lockstep:
        return _compress_huffword_device(data, conf, word_first, wv, nv, ids, dev)
    with timer.span("codebook"):
        cbs = [build_codebook(v.counts if v.n else np.zeros(1, np.int64), conf.length_limit)
               for v in (wv, nv)]
    return _bitstream_container(data, conf, ids.size, word_first, wv, nv, ids, cbs, dev)


def compress_huffword_shared(datas: list[bytes], conf: cfg.GlzConfig = cfg.DEFAULT,
                             backend: str = "host", pipeline: bool = True,
                             device=None) -> list[bytes]:
    """Compress a multi-file corpus with ONE shared dual codebook.

    Each file's vocabularies are built independently, merged with
    tokenizer.merge_vocab_parts, and every file's token ids are remapped
    into the union before encoding.  Every returned container embeds the
    full shared codebook and decodes independently.  With pipeline=True two
    files are in flight at once on a thread pool.  conf.layout and backend
    select the container as in compress_huffword."""
    rows = _check_rows(conf)
    lockstep = backend == "device" or conf.layout == cfg.LAYOUT_LOCKSTEP
    dev = resolve_device(device)
    per = [tok.build_vocabs(d) for d in datas]

    union_vocabs = []
    id_maps = []
    for cls in (3, 4):  # wv, nv of build_vocabs' return tuple
        parts = [(np.frombuffer(p[cls].blob, np.uint8),
                  np.diff(p[cls].offsets), p[cls].counts) for p in per]
        union, maps = tok.merge_vocab_parts(
            [b for b, _, _ in parts], [l for _, l, _ in parts],
            [c for _, _, c in parts])
        union_vocabs.append(union)
        id_maps.append(maps)
    uwv, unv = union_vocabs

    small = max(uwv.n, unv.n) <= 0xFFFF
    if lockstep:
        S = _huffword_stream_tokens(conf)
        rows = _capped_rows(rows, S, small)
        limit = min(conf.length_limit or MAX_FUSED_LEN, MAX_FUSED_LEN)
    else:
        limit = conf.length_limit
    with timer.span("codebook"):
        cbs = [build_codebook(uwv.counts, limit), build_codebook(unv.counts, limit)]

    def one(args):
        data, (starts, lengths, word_first, wv, nv, ids), k = args
        T = ids.size
        if T:
            is_word = (np.arange(T) % 2 == 0) == word_first
            gids = np.where(
                is_word,
                id_maps[0][k][np.minimum(ids, max(wv.n - 1, 0))] if wv.n else 0,
                id_maps[1][k][np.minimum(ids, max(nv.n - 1, 0))] if nv.n else 0)
        else:
            gids = np.zeros(0, np.int64)
        if not lockstep:
            return _bitstream_container(data, conf, T, word_first, uwv, unv, gids, cbs, dev)
        payload, group_counts = encode_lockstep_tokens(
            gids, T, word_first, cbs, uwv.n, unv.n, S, rows=rows, device=dev)
        return _lockstep_container(data, conf, T, S, rows, group_counts,
                                   huffword_cb_blob(word_first, uwv, unv, cbs), payload)

    jobs = [(d, p, k) for k, (d, p) in enumerate(zip(datas, per))]
    return _pipelined(one, jobs, pipeline)


# ---- decompress -------------------------------------------------------------

def _ranks_to_ids(ranks: torch.Tensor, cb_even: Codebook, cb_odd: Codebook, small: bool,
                  T: int, dev: torch.device) -> np.ndarray:
    """Canonical ranks in file order -> token ids np.int64 [T]: K6 on the
    card, then D2H as u16 when the vocabularies fit (`small`: 2 bytes per
    token instead of 4)."""
    n_even = max(cb_even.symbols.size, 1)
    with timer.span("tables"):
        sym_cat = _i32_tensor(np.concatenate(
            [cb_even.symbols if cb_even.symbols.size else np.zeros(1, np.uint32),
             cb_odd.symbols if cb_odd.symbols.size else np.zeros(1, np.uint32)]), dev)
    with timer.span("decode"):
        ids = map_ranks(ranks, sym_cat, n_even, small)
        del ranks
    with timer.span("d2h"):
        ids = host_array(ids[:T]).view(np.uint16 if small else np.uint32)
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
        return _i32_tensor(fc, dev), _i32_tensor(offsets, dev)


def _decompress_huffword_device(f: container.GlzFile, device=None,
                                variant: str = cfg.DECODER_TABLE):
    """Decode a HuffWord container's tokens on the card: the lockstep dual
    decode (K5) or the bitstream dual stream decode of the decoder strategy
    `variant` ("bitwalk" or "fast"; any other string the table, as glz_tpu
    takes it), then K6.  Returns (ids np.int64 [T], word_first, word_vocab,
    nonword_vocab); detokenizing happens upstream."""
    dev = resolve_device(device)
    word_first, cb_w, cb_n, wv, nv = huffword_state_from_blob(f.codebook_blob)
    # dictionary of token i: the first one when (i even) == word_first
    cb_even, cb_odd = (cb_w, cb_n) if word_first else (cb_n, cb_w)
    fc, offsets = _dual_tables(cb_even, cb_odd, dev)
    lens = (cb_even.min_len, cb_odd.min_len), (cb_even.max_len, cb_odd.max_len)

    T = f.n_symbols
    S = f.stream_symbols
    if f.layout == container.LAYOUT_LOCKSTEP:
        rows = f.group_rows
        if S & (S - 1) or not 64 <= S <= 8192:
            raise ValueError(f"corrupt .glz container: lockstep stream_symbols {S}")
        G = rows * LANES
        if f.n_streams * G * S < T:
            raise ValueError("corrupt .glz container: group table too short")
        starts, counts = group_tables(f.stream_bits, T, G, S, dev)
        payload = payload_words_on(f.payload, dev)
        with timer.span("decode"):
            ranks = decode_groups_dual(payload, starts, counts, fc, offsets, S, *lens, rows)
    else:
        if S < 1 or f.n_streams * S < T:
            raise ValueError("corrupt .glz container: stream table too short")
        with timer.span("tables"):
            sbits = f.stream_bits.astype(np.int64)
            starts = torch.from_numpy(np.cumsum(sbits) - sbits).to(dev)
        strategy = variant if variant in (cfg.DECODER_BITWALK, cfg.DECODER_FAST) \
            else cfg.DECODER_TABLE
        payload = payload_words_on(bitstream_words(f.payload), dev)
        with timer.span("decode"):
            ranks = decode_streams_dual(payload, starts, T, S, fc, offsets, *lens,
                                        variant=strategy,
                                        n_codes=(cb_even.symbols.size, cb_odd.symbols.size))
    small = max(wv.n, nv.n) <= 0xFFFF
    return _ranks_to_ids(ranks, cb_even, cb_odd, small, T, dev), word_first, wv, nv


def decompress_huffword(blob: bytes, device=None, variant: str = cfg.DECODER_TABLE) -> bytes:
    """Decode a HuffWord container of either layout (on the card, then
    detokenize on the host); `variant` picks a bitstream container's
    decoder strategy (see _decompress_huffword_device)."""
    f = container.read_container(blob)
    if f.mode != cfg.MODE_HUFFWORD:
        raise ValueError("not a huffword container")
    dev = resolve_device(device)
    if f.n_symbols == 0:
        return b"" if f.layout == container.LAYOUT_LOCKSTEP else _verify(b"", f)
    ids, word_first, wv, nv = _decompress_huffword_device(f, dev, variant)
    return _verify(tok.detokenize(ids, word_first, wv, nv), f)
