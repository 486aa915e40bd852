"""Codec model registry: the codec's model families, by name.

A copy of glz_tpu/models/__init__.py:
  canonical_byte -> byte-symbol canonical Huffman
  huffword       -> word-symbol canonical Huffman (dual dictionaries)
  normal_tree    -> the reference codec's legacy explicit tree
"""

from glz_tpu_torch import config as cfg

REGISTRY = {
    "canonical_byte": cfg.MODE_BYTE,
    "huffword": cfg.MODE_HUFFWORD,
    "normal_tree": cfg.MODE_NORMAL_TREE,
}


def by_name(name: str) -> int:
    if name not in REGISTRY:
        raise KeyError(f"unknown codec model {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
