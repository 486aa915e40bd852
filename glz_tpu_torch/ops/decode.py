"""Bitstream (layout-0) decode: several self-synchronising decoders per
stream, with one codebook (byte mode) or two alternating by token parity
(HuffWord).

Counterpart of glz_tpu/ops/decode.py:decode_block and assemble, and of the
host HuffWord decoders (glz_tpu/models/huffword.py:_decode_tokens_host, the
native decode_tokens).  Stream k holds symbols [k*S, min((k+1)*S, n)) and
starts at bit starts[k] of the payload, whose u32 words are big-endian
(bitio.bytes_to_words).  Each symbol is decoded from the 32-bit window v at
the stream's bit cursor (0 past the payload's end) by the canonical scan

    len  = min_len + sum_{l in [min_len, max_len)} [v < fc_lj[l]]
    off  = offsets[len]     (selected by the same scan)
    rank = (v >> (32 - len)) + off          (mod 2^32; no shift when len = 32)

and the cursor advances by len.  Byte mode emits symtab[rank & 255]; the
dual form emits the rank and scans codebook (k*S + j) & 1 for token j of
stream k.  Both kernels (one template) take each code from decode tables of
the window's first bits (ops/decode_table.py; decode_block's has 16) and
cut each stream into subsequences that they decode in parallel and
synchronise over (bit position, parity): subsequence_table_ref and
subsequence_table_dual_ref are the plain versions of those steps.  Byte
mode: TABLE_BITS, SUBSEQ_BITS; dual: DUAL_TABLE_BITS (the word table's),
DUAL_SUBSEQ_BITS.
The output is in file order, so assemble's transpose has no counterpart.

`variant` picks one of the reference's three decoder strategies, as
glz_tpu's host decoders (core/host_codec.py:decode_streams,
models/huffword.py:_decode_tokens_host) take it: "table" (the above),
"bitwalk" (the code accumulated one bit at a time) or "fast" (the 32-bit
window scanned up from min_len); ops/decode_table.py's bitwalk_step and
fast_step are their steps, each its own kernel in the same framework,
with no table.  The two take the codebook's count of codes (n_codes) and
raise ValueError where a code of the output matches no codeword, as
glz_tpu's fail there; the byte bit-walk reads 1 bits past the payload, as
its reference does.  For valid payloads all three give the same output.
"""

from __future__ import annotations

import torch

from glz_tpu_torch import config as cfg
from glz_tpu_torch.ops import _kernels
from glz_tpu_torch.ops.decode_table import (bitwalk_step, canonical_scan, decode_dual_ref,
                                            decode_one_ref, dual_table_ref, fast_step,
                                            table_ref)
from glz_tpu_torch.ops.lockstep_decode import CODE_TABLE
from glz_tpu_torch.ops.lockstep_encode import U32, as_u32, to_i32


# Bit positions a plain decode holds tables for at once (several int64
# arrays of this length are live).
_CHUNK_POSITIONS = 1 << 26
# The byte kernel's decode table indexes the window's first TABLE_BITS bits,
# and its decoders each start on a subsequence of SUBSEQ_BITS bits (a
# multiple of 32); both chosen by chip_smoke.py's sweep (PERF.md).
TABLE_BITS = 11
SUBSEQ_BITS = 1024
# The dual (HuffWord) kernel's word table indexes the window's first
# DUAL_TABLE_BITS bits (its separator table no more than the separators'
# longest code), and its decoders start on subsequences of
# DUAL_SUBSEQ_BITS bits; both chosen by chip_smoke.py's sweep (PERF.md).
DUAL_TABLE_BITS = 12
DUAL_SUBSEQ_BITS = 384

# The decoder strategies without a table and their kernels' codes
# (decode_table.cuh: kBitwalk, kFast); "table" is the kernels above.
TABLE, BITWALK, FAST = cfg.DECODER_TABLE, cfg.DECODER_BITWALK, cfg.DECODER_FAST
STRATEGIES = {BITWALK: 1, FAST: 2}
NO_CODEWORD = "corrupt stream: no codeword matched"


def _check_variant(variant: str, n_codes) -> None:
    if variant not in (TABLE, *STRATEGIES):
        raise ValueError(f"unknown decoder variant {variant!r}")
    if variant != TABLE and n_codes is None:
        raise ValueError(f"the {variant} decode needs the codebook's n_codes")


def _plain_decode(words, starts, n_symbols: int, S: int, codebooks, variant: str,
                  n_codes, fill: int = 0) -> torch.Tensor:
    """_decode_ref with the variant's step: the canonical scan for the
    table (its tables change no output), else the strategy's step with each
    codebook's n_codes, raising where a code of the output matches no
    codeword."""
    if variant == TABLE:
        return _decode_ref(words, starts, n_symbols, S, codebooks)
    rank = _decode_ref(words, starts, n_symbols, S,
                       [(*cb, n) for cb, n in zip(codebooks, n_codes)],
                       step=bitwalk_step if variant == BITWALK else fast_step, fill=fill)
    if bool((rank < 0).any()):
        raise ValueError(NO_CODEWORD)
    return rank


def _window(P: torch.Tensor, B: int, p: torch.Tensor) -> torch.Tensor:
    """The 32-bit windows (u32 values in int64) at bit positions p of the
    zero-extended payload P of B bits; positions at or past B read 0."""
    p = p.clamp(max=B)
    phase = p & 31
    hi = P[p >> 5]
    lo_w = P[(p >> 5) + 1]
    return torch.where(phase > 0, ((hi << phase) & U32) | (lo_w >> ((32 - phase) & 31)), hi)


def _position_tables(P: torch.Tensor, lo: int, n_pos: int, *codebook,
                     step=canonical_scan):
    """(length, rank) int64 [n_pos] of a code starting at each bit position
    lo + i of the extended payload P (u32 values in int64): step(windows,
    *codebook), by default the canonical scan of (fc_lj, offsets, min_len,
    max_len)."""
    v = _window(P, 32 * (P.numel() - 2), torch.arange(lo, lo + n_pos, device=P.device))
    return step(v, *codebook)


def _chains(P: torch.Tensor, B: int, starts: torch.Tensor, first: torch.Tensor,
            M: int, codebooks, positions: bool = False, step=canonical_scan):
    """Ranks int64 [len(starts), M]: M steps of each stream's walk from bit
    starts[i] (in [0, B]), its first token of parity class first[i] %
    len(codebooks); with positions, also each step's bit position (the
    walk's code boundaries; positions past B read as B) and parity class.
    Each class's codes are step(windows, *its codebook).

    The code length and rank are tabled for every bit position a walk can
    reach (M steps of at most 32 bits from a start; positions at or past the
    payload's last bit B see the window of the fill past it, so they fold
    into B), then the walks follow the table by pointer doubling: log2(M)
    rounds."""
    dev = P.device
    lo = int(starts.min())
    top = min(int(starts.max()) + 32 * M, B)
    n_pos = top - lo + 1
    n_cls = len(codebooks)
    jumps, ranks = [], []
    for c, cb in enumerate(codebooks):
        ln, rank = _position_tables(P, lo, n_pos, *cb, step=step)
        to = (torch.arange(n_pos, device=dev) + ln).clamp_(max=n_pos - 1)
        jumps.append(to + ((c + 1) % n_cls) * n_pos)  # the next token's class
        ranks.append(rank)
        del ln
    jump = torch.cat(jumps)
    rank_at = torch.cat(ranks)
    del jumps, ranks
    pos = torch.empty((starts.numel(), M), dtype=torch.int64, device=dev)
    pos[:, 0] = starts - lo + (first % n_cls) * n_pos
    width = 1
    while width < M:
        take = min(width, M - width)
        pos[:, width : width + take] = jump[pos[:, :take]]
        width += take
        if width < M:
            jump = jump[jump]
    if positions:
        return rank_at[pos], pos % n_pos + lo, pos // n_pos
    return rank_at[pos]


def _decode_ref(words: torch.Tensor, starts: torch.Tensor, n_symbols: int, S: int,
                codebooks, step=canonical_scan, fill: int = 0) -> torch.Tensor:
    """Canonical ranks int64 [n_symbols] in file order; codebooks: one
    (fc_lj, offsets, min_len, max_len) per token parity class, the args
    after the windows of `step` (the canonical scan, or a strategy's step,
    which gives rank -1 where no codeword matches); the payload reads
    `fill` words past its end.

    A loop of S Python steps is far too slow at S = 2^18, so the plain
    version splits each stream's serial walk into two vectorised halves with
    the same result (_chains), over groups of streams whose reachable bit
    positions fit _CHUNK_POSITIONS."""
    dev = words.device
    B = 32 * words.numel()
    P = torch.cat([as_u32(words), words.new_full((2,), fill, dtype=torch.int64)])
    L = starts.numel()
    M = S if L > 1 else n_symbols  # steps to follow per stream
    st = starts.clamp(0, B)
    st_host = st.tolist()
    out = torch.empty(n_symbols, dtype=torch.int64, device=dev)
    k0 = 0
    while k0 * S < n_symbols:
        k1, lo, hi = k0 + 1, st_host[k0], st_host[k0]
        while (k1 < L and k1 * S < n_symbols
               and max(hi, st_host[k1]) - min(lo, st_host[k1]) + 32 * M <= _CHUNK_POSITIONS):
            lo, hi = min(lo, st_host[k1]), max(hi, st_host[k1])
            k1 += 1
        k = torch.arange(k0, k1, device=dev)
        ranks = _chains(P, B, st[k0:k1], k * S, M, codebooks, step=step)
        end = min(k1 * S, n_symbols) if L > 1 else n_symbols
        out[k0 * S : end] = ranks.view(-1)[: end - k0 * S]
        k0 = k1
    return out


def _check_decode(words: torch.Tensor, starts: torch.Tensor, n_symbols: int,
                  S: int) -> None:
    dev = words.device
    _kernels.check(words, "words", torch.int32, (words.numel(),), dev)
    _kernels.check(starts, "starts", torch.int64, (starts.numel(),), dev)
    if S < 1 or n_symbols < 0:
        raise ValueError(f"bad geometry: S {S}, n_symbols {n_symbols}")
    if starts.numel() * S < n_symbols or (n_symbols and starts.numel() == 0):
        raise ValueError("corrupt .glz container: stream table too short")
    if starts.numel() and int(starts.min()) < 0:
        raise ValueError("corrupt .glz container: negative stream start")


def _check_range(lo: int, hi: int, empty_ok: bool) -> None:
    if not ((empty_ok and (lo, hi) == (0, 0)) or 1 <= lo <= hi <= 32):
        raise ValueError(f"bad code length range [{lo}, {hi}]")


# ---- byte mode ---------------------------------------------------------------

def decode_streams_ref(words: torch.Tensor, starts: torch.Tensor, n_symbols: int,
                       S: int, fc_lj: torch.Tensor, offsets: torch.Tensor,
                       symtab: torch.Tensor, min_len: int, max_len: int,
                       variant: str = TABLE, n_codes: int | None = None) -> torch.Tensor:
    """Plain version of the stream decode: u8 [n_symbols] in file order,
    symtab[rank & 255] per symbol (see the module docstring), by the
    variant's strategy; n_codes: the codebook's symbols, which "bitwalk"
    and "fast" need."""
    _check_variant(variant, n_codes)
    if n_symbols == 0:
        return torch.zeros(0, dtype=torch.uint8, device=words.device)
    rank = _plain_decode(words, starts, n_symbols, S, [(fc_lj, offsets, min_len, max_len)],
                         variant, [n_codes], fill=0xFFFFFFFF if variant == BITWALK else 0)
    return as_u32(symtab)[rank & 255].to(torch.uint8)


def _subsequence_steps(words: torch.Tensor, starts: torch.Tensor, n_symbols: int, S: int,
                       T: int, lengths, flip: int, rounds: int | None):
    """The subsequence steps of csrc/bitstream.cu's decode_streams_sync_kernel
    (steps 1 and 2) on decoder states (bit position, parity): lengths(v,
    par) gives the advance of windows v at parities par, and each code
    flips the parity by `flip` (0 in byte mode).  Subsequence 0 of stream k
    starts at (starts[k], (k*S) & flip), every other at its first bit with
    the same parity.  See subsequence_table_ref."""
    dev = words.device
    B = 32 * words.numel()
    P = torch.cat([as_u32(words), words.new_zeros(2, dtype=torch.int64)])
    L = starts.numel()
    k = torch.arange(L, device=dev)
    count = (n_symbols - k * S).clamp(0, S)
    stop = torch.cat([starts[1:], torch.tensor([B], device=dev)])
    span = torch.minimum(stop - starts, 32 * count).clamp(min=0)
    n_sub = torch.where(count > 0, ((span + T - 1) // T).clamp(min=1), 0)
    stream = torch.repeat_interleave(k, n_sub)
    sub = torch.arange(stream.numel(), device=dev) - (torch.cumsum(n_sub, 0) - n_sub)[stream]
    nominal = starts[stream] + sub * T
    end = nominal + T
    bounded = sub < n_sub[stream] - 1
    start = nominal.clone()
    start_par = (stream * S) & flip
    exit_ = torch.full_like(start, -1)
    exit_par = torch.full_like(start, -1)
    cnt = torch.full_like(start, -1)

    def run(sel: torch.Tensor) -> None:
        """Decode the selected subsequences from their starts to their ends."""
        pos, par, end_s = start[sel], start_par[sel], end[sel]
        n = torch.zeros_like(pos)
        live = pos < end_s
        while bool(live.any()):
            pos[live] += lengths(_window(P, B, pos[live]), par[live])
            par[live] ^= flip
            n[live] += 1
            live = pos < end_s
        exit_[sel], exit_par[sel], cnt[sel] = pos, par, n

    run(bounded)
    n_rounds = 0
    while rounds is None or n_rounds < rounds:
        want = torch.where(sub > 0, torch.roll(exit_, 1), start)
        want_par = torch.where(sub > 0, torch.roll(exit_par, 1), start_par)
        changed = (want != start) | (want_par != start_par)
        if not bool(changed.any()):
            break
        start = torch.where(changed, want, start)
        start_par = torch.where(changed, want_par, start_par)
        run(changed & bounded)
        n_rounds += 1
    return stream, start, start_par, exit_, exit_par, cnt, n_rounds


def subsequence_table_ref(words: torch.Tensor, starts: torch.Tensor, n_symbols: int,
                          S: int, fc_lj: torch.Tensor, offsets: torch.Tensor,
                          symtab: torch.Tensor, min_len: int, max_len: int, T: int,
                          table_bits: int = TABLE_BITS, rounds: int | None = None):
    """Plain version of the byte kernel's subsequence steps (csrc/bitstream.cu:
    decode_streams_sync_kernel, steps 1 and 2).

    Stream k (with count = min(S, n_symbols - k*S) > 0) spans
    clamp(starts[k+1] - starts[k], 0, 32*count) bits (the last stream's run
    to the payload's end), cut into n = max(ceil(span / T), 1) subsequences
    from starts[k]; subsequence i < n-1 decodes the codes that start in
    [starts[k] + iT, starts[k] + (i+1)T), and the last one runs until the
    stream has its count, so it has no exit.  Step 1 starts subsequence 0 at
    starts[k] and every other at its first bit; each synchronisation round
    restarts every subsequence whose start differs from its predecessor's
    exit, from that exit, until none does (or after `rounds` rounds; 0 gives
    step 1's table).  Any T >= 32 is accepted here (the kernel takes
    multiples of 32).

    Returns (stream, start, exit, count, rounds): int64 tensors over the
    subsequences in stream order (exit and count -1 for each stream's last
    subsequence) and the number of rounds that changed a start."""
    table = table_ref(fc_lj, offsets, symtab, min_len, max_len, table_bits)

    def lengths(v, _par):
        return decode_one_ref(v, table, fc_lj, offsets, symtab, max_len, table_bits)[0]

    stream, start, _, exit_, _, cnt, n_rounds = _subsequence_steps(
        words, starts, n_symbols, S, T, lengths, 0, rounds)
    return stream, start, exit_, cnt, n_rounds


def _raise_if_flagged(err: torch.Tensor) -> None:
    """A strategy kernel's flag, read back (a synchronisation): 1 where a
    code of the output matched no codeword."""
    if int(err.item()):
        raise ValueError(NO_CODEWORD)


def decode_streams(words: torch.Tensor, starts: torch.Tensor, n_symbols: int, S: int,
                   fc_lj: torch.Tensor, offsets: torch.Tensor, symtab: torch.Tensor,
                   min_len: int, max_len: int, variant: str = TABLE,
                   n_codes: int | None = None) -> torch.Tensor:
    """The byte-mode stream decode (replaces glz_tpu/ops/decode.py:
    decode_block with assemble; with variant "bitwalk" or "fast",
    glz_tpu/core/host_codec.py's decode_stream_bitwalk or
    decode_stream_fast).  See decode_streams_ref for the function; CUDA
    tensors launch the variant's kernel.

    words: int32 [W] (u32 big-endian-order words); starts: int64 [L] bit
    offsets, each >= 0; fc_lj/offsets: int32 [34]; symtab: int32 [256];
    n_codes: the codebook's symbols (1-256), for "bitwalk" and "fast"."""
    _check_range(min_len, max_len, empty_ok=False)
    _check_variant(variant, n_codes)
    dev = words.device
    _check_decode(words, starts, n_symbols, S)
    _kernels.check(fc_lj, "fc_lj", torch.int32, (CODE_TABLE,), dev)
    _kernels.check(offsets, "offsets", torch.int32, (CODE_TABLE,), dev)
    _kernels.check(symtab, "symtab", torch.int32, (256,), dev)
    if _kernels.runs_plain(words):
        return decode_streams_ref(words, starts, n_symbols, S, fc_lj, offsets, symtab,
                                  min_len, max_len, variant, n_codes)
    out = torch.empty(n_symbols, dtype=torch.uint8, device=dev)
    if n_symbols and variant == TABLE:
        _kernels.launch("glz_decode_streams", "decode_streams", _kernels.ptr(words),
                        words.numel(), _kernels.ptr(starts), starts.numel(), n_symbols, S,
                        TABLE_BITS, _kernels.ptr(fc_lj),
                        _kernels.ptr(offsets), _kernels.ptr(symtab), min_len, max_len,
                        SUBSEQ_BITS, _kernels.ptr(out))
    elif n_symbols:
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        _kernels.launch("glz_decode_streams_strategy", f"decode_streams_{variant}",
                        STRATEGIES[variant], _kernels.ptr(words), words.numel(),
                        _kernels.ptr(starts), starts.numel(), n_symbols, S,
                        _kernels.ptr(fc_lj), _kernels.ptr(offsets), _kernels.ptr(symtab),
                        min_len, max_len, n_codes, SUBSEQ_BITS, _kernels.ptr(err),
                        _kernels.ptr(out))
        _raise_if_flagged(err)
    return out


# ---- HuffWord: two codebooks alternating by token parity ----------------------

def decode_streams_dual_ref(words: torch.Tensor, starts: torch.Tensor, n_symbols: int,
                            S: int, fc_lj: torch.Tensor, offsets: torch.Tensor,
                            min_lens, max_lens, variant: str = TABLE,
                            n_codes=None) -> torch.Tensor:
    """Plain version of the dual stream decode: canonical ranks, int32 (u32
    bit patterns) [n_symbols] in file order; token i scans codebook i & 1
    (row 0 of fc_lj/offsets is the even tokens'), by the variant's
    strategy; n_codes: (even, odd) codebooks' codes, for "bitwalk" and
    "fast"."""
    _check_variant(variant, n_codes)
    if n_symbols == 0:
        return torch.zeros(0, dtype=torch.int32, device=words.device)
    rank = _plain_decode(words, starts, n_symbols, S,
                         [(fc_lj[p], offsets[p], min_lens[p], max_lens[p]) for p in (0, 1)],
                         variant, n_codes)
    return to_i32(rank)


def subsequence_table_dual_ref(words: torch.Tensor, starts: torch.Tensor, n_symbols: int,
                               S: int, fc_lj: torch.Tensor, offsets: torch.Tensor, min_lens,
                               max_lens, T: int, table_bits: int = DUAL_TABLE_BITS,
                               rounds: int | None = None):
    """Plain version of the dual kernel's subsequence steps: those of
    subsequence_table_ref on decoder states (bit position, parity).  A
    code at parity p is decoded with codebook p's table (decode_dual_ref)
    and flips the parity; subsequence 0 of stream k starts at (starts[k],
    (k*S) & 1) and every other guess takes the same parity; a round
    restarts a subsequence whose start state (position or parity) differs
    from its predecessor's exit state.  An empty dictionary's codebook
    decodes a length of 0, which the guesses and rounds advance by 1 (no
    valid token uses it).

    Returns (stream, start, start parity, exit, exit parity, count, rounds):
    int64 tensors over the subsequences in stream order (exit, its parity
    and count -1 for each stream's last subsequence) and the rounds."""
    tables = [dual_table_ref(fc_lj[p], offsets[p], min_lens[p], max_lens[p], table_bits)
              for p in (0, 1)]

    def lengths(v, par):
        ln = [decode_dual_ref(v, tables[p], fc_lj[p], offsets[p], max_lens[p], table_bits)[0]
              for p in (0, 1)]
        return torch.where(par == 1, ln[1], ln[0]).clamp(min=1)

    return _subsequence_steps(words, starts, n_symbols, S, T, lengths, 1, rounds)


def decode_streams_dual(words: torch.Tensor, starts: torch.Tensor, n_symbols: int,
                        S: int, fc_lj: torch.Tensor, offsets: torch.Tensor,
                        min_lens, max_lens, variant: str = TABLE, n_codes=None) -> torch.Tensor:
    """The HuffWord stream decode (replaces the host dual-dictionary decode
    of glz_tpu/models/huffword.py:decompress_huffword; with variant
    "bitwalk" or "fast", the branches of its _decode_tokens_host).  See
    decode_streams_dual_ref for the function; CUDA tensors launch the
    variant's kernel.

    fc_lj, offsets: int32 [2, 34]; min_lens, max_lens: (even, odd) code
    length ranges, each [0, 0] for an empty dictionary or within [1, 32];
    n_codes: (even, odd) codebooks' codes, for "bitwalk" and "fast"."""
    for lo, hi in zip(min_lens, max_lens):
        _check_range(lo, hi, empty_ok=True)
    _check_variant(variant, n_codes)
    dev = words.device
    _check_decode(words, starts, n_symbols, S)
    _kernels.check(fc_lj, "fc_lj", torch.int32, (2, CODE_TABLE), dev)
    _kernels.check(offsets, "offsets", torch.int32, (2, CODE_TABLE), dev)
    if _kernels.runs_plain(words):
        return decode_streams_dual_ref(words, starts, n_symbols, S, fc_lj, offsets,
                                       min_lens, max_lens, variant, n_codes)
    out = torch.empty(n_symbols, dtype=torch.int32, device=dev)
    if n_symbols and variant == TABLE:
        _kernels.launch("glz_decode_streams_dual", "decode_streams_dual",
                        _kernels.ptr(words), words.numel(), _kernels.ptr(starts),
                        starts.numel(), n_symbols, S, DUAL_TABLE_BITS, _kernels.ptr(fc_lj),
                        _kernels.ptr(offsets), min_lens[0], max_lens[0], min_lens[1],
                        max_lens[1], DUAL_SUBSEQ_BITS, _kernels.ptr(out))
    elif n_symbols:
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        _kernels.launch("glz_decode_streams_dual_strategy", f"decode_streams_dual_{variant}",
                        STRATEGIES[variant], _kernels.ptr(words), words.numel(),
                        _kernels.ptr(starts), starts.numel(), n_symbols, S,
                        _kernels.ptr(fc_lj), _kernels.ptr(offsets), min_lens[0], max_lens[0],
                        min_lens[1], max_lens[1], n_codes[0], n_codes[1], DUAL_SUBSEQ_BITS,
                        _kernels.ptr(err), _kernels.ptr(out))
        _raise_if_flagged(err)
    return out
