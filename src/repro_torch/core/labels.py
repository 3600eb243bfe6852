"""Label substrate: bitmask codec + workload generators.

A label set is encoded as a fixed-width bitmask (``NUM_WORDS`` x uint64),
supporting label universes up to ``MAX_LABELS`` labels.  Containment
(``L_q ⊆ L_i``) is two AND/CMP ops per word — the representation used both
host-side (selection) and device-side (the CUDA scan kernels, which consume
the same words as ``LABEL_WORDS`` int32 words).

Workload generators reproduce the paper's §6 label distributions: Zipf
(power law, the primary setting), Uniform, Poisson and Multinormal.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

MAX_LABELS = 128
NUM_WORDS = MAX_LABELS // 64
LABEL_WORDS = 2 * NUM_WORDS     # int32 words per mask on the device


def encode_label_set(labels: Iterable[int]) -> np.ndarray:
    """Encode an iterable of label ids into a (NUM_WORDS,) uint64 bitmask."""
    mask = np.zeros(NUM_WORDS, dtype=np.uint64)
    for lab in labels:
        if not 0 <= lab < MAX_LABELS:
            raise ValueError(f"label id {lab} out of range [0, {MAX_LABELS})")
        mask[lab // 64] |= np.uint64(1) << np.uint64(lab % 64)
    return mask


def decode_label_set(mask: np.ndarray) -> tuple[int, ...]:
    """Inverse of :func:`encode_label_set` (sorted tuple of label ids)."""
    out = []
    for w in range(NUM_WORDS):
        word = int(mask[w])
        while word:
            lsb = word & -word
            out.append(w * 64 + lsb.bit_length() - 1)
            word ^= lsb
    return tuple(out)


def encode_many(label_sets: Sequence[Iterable[int]]) -> np.ndarray:
    """Encode N label sets into an (N, NUM_WORDS) uint64 array.

    Distinct sets are encoded once (a Zipf workload of a million rows
    holds a few thousand distinct sets); the result is the row-by-row
    :func:`encode_label_set` encoding."""
    out = np.zeros((len(label_sets), NUM_WORDS), dtype=np.uint64)
    seen: dict[tuple[int, ...], np.ndarray] = {}
    for i, ls in enumerate(label_sets):
        key = tuple(ls)
        mask = seen.get(key)
        if mask is None:
            mask = seen[key] = encode_label_set(key)
        out[i] = mask
    return out


def contains(haystack: np.ndarray, needle: np.ndarray) -> np.ndarray:
    """Vectorized containment test: ``needle ⊆ haystack`` row-wise.

    ``haystack``: (N, NUM_WORDS) uint64 — database label masks.
    ``needle``:   (NUM_WORDS,) uint64   — query label mask.
    Returns (N,) bool.
    """
    return np.all((haystack & needle[None, :]) == needle[None, :], axis=1)


def mask_key(mask: np.ndarray) -> tuple[int, ...]:
    """Hashable key for a bitmask."""
    return tuple(int(w) for w in mask)


def key_to_mask(key: tuple[int, ...]) -> np.ndarray:
    return np.array(key, dtype=np.uint64)


def key_contains(hay: tuple[int, ...], needle: tuple[int, ...]) -> bool:
    """``needle ⊆ hay`` on hashable keys."""
    return all((h & n) == n for h, n in zip(hay, needle))


def key_popcount(key: tuple[int, ...]) -> int:
    return sum(int(w).bit_count() for w in key)


def key_subsets(key: tuple[int, ...]):
    """Yield every subset key of ``key`` (including empty and itself).

    Classic subset-lattice walk; cost 2^|key| — exactly the paper's
    O(Σ 2^|L_i|) closure expansion (§4.2).  Subset ``bits`` holds label
    ``i`` (the key's labels in ascending order) iff bit ``i`` of ``bits``
    is set, as in the JAX package; the masks are built with integer
    arithmetic, one OR a subset, instead of one encode each.
    """
    singles = []          # the key's labels as one-bit masks, ascending
    for w, word in enumerate(key):
        word = int(word)
        while word:
            low = word & -word
            singles.append(low << (64 * w))
            word ^= low
    subs = [0] * (1 << len(singles))
    for bits in range(1, len(subs)):
        low = bits & -bits
        subs[bits] = subs[bits ^ low] | singles[low.bit_length() - 1]
    words = range(NUM_WORDS)
    for sub in subs:
        yield tuple((sub >> (64 * w)) & 0xFFFFFFFFFFFFFFFF for w in words)


def masks_to_int32_words(masks: np.ndarray) -> np.ndarray:
    """Reinterpret (N, NUM_WORDS) uint64 masks as (N, 2*NUM_WORDS) int32.

    The device kernels operate on 32-bit words; they consume the bitmask
    as int32 words.  Little-endian word order matches
    ``np.ndarray.view`` on LE hosts.
    """
    return masks.view(np.uint32).astype(np.int32).reshape(masks.shape[0], 2 * NUM_WORDS)


# ---------------------------------------------------------------------------
# Workload generation (paper §6: Zipf primary; Uniform / Poisson / Multinormal)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LabelWorkloadConfig:
    num_labels: int = 12           # |𝓛| — size of the label universe
    distribution: str = "zipf"     # zipf | uniform | poisson | multinormal
    zipf_a: float = 1.5            # Zipf exponent (paper uses UNG's generator)
    mean_set_size: float = 3.0     # expected |L_i|
    max_set_size: int = 8
    seed: int = 0


def _sample_set_sizes(rng: np.random.Generator, n: int, cfg: LabelWorkloadConfig) -> np.ndarray:
    sizes = rng.poisson(cfg.mean_set_size, size=n)
    return np.clip(sizes, 0, min(cfg.max_set_size, cfg.num_labels))


def generate_label_sets(n: int, cfg: LabelWorkloadConfig) -> list[tuple[int, ...]]:
    """Sample N base label sets under the configured distribution.

    Distribution controls the *per-label popularity*; the set size is
    Poisson(mean_set_size) clipped to [0, max_set_size] (labels within one
    entry are sampled without replacement, weighted by popularity).
    """
    rng = np.random.default_rng(cfg.seed)
    L = cfg.num_labels
    if cfg.distribution == "zipf":
        weights = 1.0 / np.arange(1, L + 1) ** cfg.zipf_a
    elif cfg.distribution == "uniform":
        weights = np.ones(L)
    elif cfg.distribution == "poisson":
        # popularity profile shaped like a Poisson pmf over label ids
        lam = max(L / 4.0, 1.0)
        ids = np.arange(L)
        logpmf = ids * np.log(lam) - lam - np.array(
            [float(np.sum(np.log(np.arange(1, i + 1)))) for i in ids])
        weights = np.exp(logpmf - logpmf.max())
    elif cfg.distribution == "multinormal":
        ids = np.arange(L)
        c1, c2 = L / 4.0, 3 * L / 4.0
        s = max(L / 8.0, 1.0)
        weights = np.exp(-0.5 * ((ids - c1) / s) ** 2) + 0.7 * np.exp(-0.5 * ((ids - c2) / s) ** 2)
    else:
        raise ValueError(f"unknown distribution {cfg.distribution!r}")
    weights = weights / weights.sum()

    sizes = _sample_set_sizes(rng, n, cfg)
    out: list[tuple[int, ...]] = []
    for sz in sizes:
        if sz == 0:
            out.append(())
            continue
        chosen = rng.choice(L, size=int(sz), replace=False, p=weights)
        out.append(tuple(sorted(int(c) for c in chosen)))
    return out


def generate_query_label_sets(
    base_sets: Sequence[tuple[int, ...]], n_queries: int, seed: int = 1,
    from_base_fraction: float = 1.0,
) -> list[tuple[int, ...]]:
    """Sample query label sets.

    Following the paper (and UNG's generator), query label sets are drawn as
    random subsets of base label sets so that every query has a non-empty
    filtered set.  ``from_base_fraction`` < 1 mixes in uniform subsets of the
    label universe (possibly empty-result queries) for robustness tests.
    """
    rng = np.random.default_rng(seed)
    nonempty = [b for b in base_sets if b] or [()]
    all_labels = sorted({lab for b in base_sets for lab in b}) or [0]
    out: list[tuple[int, ...]] = []
    for _ in range(n_queries):
        if rng.random() < from_base_fraction:
            base = nonempty[rng.integers(len(nonempty))]
            if not base:
                out.append(())
                continue
            sz = rng.integers(1, len(base) + 1)
            chosen = rng.choice(len(base), size=int(sz), replace=False)
            out.append(tuple(sorted(base[c] for c in chosen)))
        else:
            sz = rng.integers(1, min(4, len(all_labels)) + 1)
            chosen = rng.choice(len(all_labels), size=int(sz), replace=False)
            out.append(tuple(sorted(all_labels[c] for c in chosen)))
    return out
