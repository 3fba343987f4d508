"""The index as one segment: `SearchEngine.build` over every drawn text,
every document live. A configuration without a `setup` key takes it."""


def alive(cfg: dict, n_docs: int, seed: int):
    """The live documents that `build` leaves: all of them."""
    return None


def build(eng, texts: list, cfg: dict, seed: int):
    """Builds the index from the texts; returns `alive`'s mask (None)."""
    eng.build(texts)
    return None
