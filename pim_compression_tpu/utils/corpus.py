"""Seeded stand-ins for the reference's test corpus.

The reference ships text files (``alice`` … ``world192``, an XML file)
with ``.snappy`` twins made by its own compressor at 32 KB blocks
(BASELINE.md). Those files are not redistributed here, so tests, scripts
and ``chip_smoke.py`` use files generated from ``np.random.default_rng``:
same names and sizes, text-like and XML-like content, plus incompressible
bytes. Each ``.snappy`` twin is made by the native C++ codec, so a test
that compares the oracle's stream with the twin compares two independent
implementations. ``DIGESTS`` pins the twins: a generator whose output
drifts fails ``tests/test_corpus.py``.
"""

from __future__ import annotations

import hashlib
import pathlib

import numpy as np

from pim_compression_tpu.format import constants as C

# name -> size in bytes (the reference corpus sizes, BASELINE.md).
TEXT_SIZES = {
    "alice": 312,
    "coding": 9_423,
    "terror2": 105_438,
    "plrabn12": 481_861,
    "world192": 1_150_480,
}
XML_SIZE = 5_345_280
RANDOM_SIZE = 1 << 20
NAMES = (*TEXT_SIZES, "xml", "random")

# SHA-256 of each .snappy twin at seed 0.
DIGESTS = {
    "alice": "d70992371b070207c39941a7714d40cba4b7dadef5949d0a864d09c345e82b2b",
    "coding": "0797fcef092abc6cf427f09d31fd7397ba786fd10f9b19b5d0840de2705ae32a",
    "terror2": "6320746e558b624ed1b25396c3dd5a83b04d38f256f03af6920fdaff4c1328f4",
    "plrabn12": "19b9cf50f25e4ef2c64d11d4d57dd0c28afeed4d7f9880b5c9c2ecfba7a030dc",
    "world192": "8de2f39cc2f176c63f39bfd237bf21b80dd8fa0726dff49e42cac865f51c1703",
    "xml": "0fbce7a540d83b4a95a86ac043c2dfa9324d1032c4ddfdab105ec8a27024d90d",
    "random": "7cc2919d4f9e07aa15c6c6124fe3b15e1c79224bae17a1eaddac4626dcc06b87",
}

# English letter frequencies (per mille), for word spelling.
_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
_LETTER_P = np.array(
    [127, 91, 82, 75, 70, 67, 63, 61, 60, 43, 40, 28, 28, 24, 24, 22, 20,
     20, 19, 15, 10, 8, 2, 2, 1, 1], np.float64,
)
_LETTER_P /= _LETTER_P.sum()
_CHUNK = 1 << 22  # bytes generated per vectorized step


def _words(rng: np.random.Generator, count: int) -> list[bytes]:
    """``count`` distinct-ish lowercase words, 1-12 letters, short-biased."""
    lens = np.clip(rng.geometric(0.22, count), 1, 12)
    letters = rng.choice(_LETTERS, size=int(lens.sum()), p=_LETTER_P)
    cuts = np.cumsum(lens)[:-1]
    return [w.tobytes() for w in np.split(letters, cuts)]


def _zipf_ids(rng: np.random.Generator, vocab: int, count: int) -> np.ndarray:
    """Word ranks drawn with probability ~ 1/(rank + 3): natural-text skew."""
    cdf = np.cumsum(1.0 / (np.arange(vocab) + 3.0))
    return np.searchsorted(cdf, rng.random(count) * cdf[-1]).astype(np.int64)


def _gather(table: list[bytes], ids: np.ndarray) -> np.ndarray:
    """Concatenate ``table[i] for i in ids`` without a Python loop."""
    flat = np.frombuffer(b"".join(table), np.uint8)
    lens = np.array([len(t) for t in table], np.int64)
    offs = np.cumsum(lens) - lens
    ln = lens[ids]
    total = int(ln.sum())
    starts = np.cumsum(ln) - ln
    src = np.repeat(offs[ids] - starts, ln) + np.arange(total, dtype=np.int64)
    return flat[src]


def _fill(n: int, chunk) -> bytes:
    """Call ``chunk()`` (one vectorized batch of bytes) until ``n`` bytes."""
    parts, have = [], 0
    while have < n:
        part = chunk()
        parts.append(part)
        have += part.size
    return np.concatenate(parts)[:n].tobytes()


def text_like(n: int, seed: int) -> bytes:
    """Prose-like bytes: Zipf-distributed words, punctuation, line breaks."""
    rng = np.random.default_rng(seed)
    words = _words(rng, 6000)
    # Separators follow each word: mostly spaces, some punctuation/newlines.
    seps = [b" ", b", ", b". ", b".\n", b"\n", b"; "]
    sep_p = np.array([0.84, 0.06, 0.05, 0.02, 0.02, 0.01])
    table = words + seps
    per_chunk = min(n, _CHUNK) // 4 + 1

    def chunk():
        w = _zipf_ids(rng, len(words), per_chunk)
        s = len(words) + rng.choice(len(seps), size=per_chunk, p=sep_p)
        return _gather(table, np.stack([w, s], axis=1).reshape(-1))

    return _fill(n, chunk)


def xml_like(n: int, seed: int) -> bytes:
    """Markup-like bytes: repeated record templates whose fields are
    drawn from small vocabularies (ids, names, years, Zipf words)."""
    rng = np.random.default_rng(seed)
    words = [w + b" " for w in _words(rng, 400)]
    names = [
        a.capitalize() + b" " + b.capitalize()
        for a, b in zip(_words(rng, 400), _words(rng, 400))
    ]
    ids = [b"%06d" % i for i in rng.integers(0, 10**6, 4096)]
    years = [b"%d" % y for y in range(1950, 2010)]
    kinds = [b"article", b"inproceedings", b"book", b"phdthesis", b"www"]
    journals = [b"Journal of " + w.capitalize() for w in _words(rng, 40)]
    lits = [
        b'<record key="', b'" type="', b'">\n  <author>',
        b"</author>\n  <title>", b"</title>\n  <year>",
        b"</year>\n  <journal>", b"</journal>\n  <abstract>",
        b"</abstract>\n</record>\n", b"",
    ]
    table, base = list(lits), {}
    for key, group in (("words", words), ("names", names), ("ids", ids),
                       ("years", years), ("kinds", kinds),
                       ("journals", journals)):
        base[key] = len(table)
        table += group
    empty = lits.index(b"")
    title_w, text_w = 6, 12
    recs = min(n, _CHUNK) // 200 + 1

    def words_field(count, keep):
        w = base["words"] + _zipf_ids(rng, len(words), recs * count)
        w = w.reshape(recs, count)
        return np.where(rng.random((recs, count)) < keep, w, empty)

    def one(key, count):
        return base[key] + rng.integers(0, count, (recs, 1))

    def chunk():
        def col(i):
            return np.full((recs, 1), i)

        grid = np.concatenate([
            col(0), one("ids", len(ids)),
            col(1), one("kinds", len(kinds)),
            col(2), one("names", len(names)),
            col(3), words_field(title_w, 0.6),
            col(4), one("years", len(years)),
            col(5), one("journals", len(journals)),
            col(6), words_field(text_w, 0.7),
            col(7),
        ], axis=1)
        return _gather(table, grid.reshape(-1))

    return _fill(n, chunk)


def incompressible(n: int, seed: int) -> bytes:
    """Uniform random bytes: no repeated 4-grams to speak of."""
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def generate(name: str, seed: int = 0) -> bytes:
    """The plain bytes of corpus file ``name``."""
    sub = (seed, NAMES.index(name))
    if name in TEXT_SIZES:
        return text_like(TEXT_SIZES[name], sub)
    if name == "xml":
        return xml_like(XML_SIZE, sub)
    if name == "random":
        return incompressible(RANDOM_SIZE, sub)
    raise KeyError(name)


def twin(plain: bytes) -> bytes:
    """The ``.snappy`` twin: the native codec's stream at 32 KB blocks."""
    from pim_compression_tpu import native

    if not native.available():
        raise RuntimeError("the native codec is needed to make corpus twins")
    return native.compress(plain, C.DEFAULT_BLOCK_SIZE)


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def write(directory: str | pathlib.Path, seed: int = 0) -> pathlib.Path:
    """Write ``<name>.txt`` and ``<name>.snappy`` for every corpus file."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for name in NAMES:
        plain = generate(name, seed)
        (directory / f"{name}.txt").write_bytes(plain)
        (directory / f"{name}.snappy").write_bytes(twin(plain))
    return directory
