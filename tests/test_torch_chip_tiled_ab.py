"""chip_tiled_ab.py's pieces that run without the card: the legs it
accepts and the copy of csrc/fused_tiled.cu with other tile constants."""
import re
from pathlib import Path

import pytest

import chip_tiled_ab as A
from document_search_engine_tpu_torch.ops import fused as F

SOURCE = (Path(F.CSRC) / "fused_tiled.cu").read_text()


@pytest.mark.parametrize("log2,tpb", [(13, 64), (15, 16)])
def test_tile_source_sets_both_constants_and_nothing_else(log2, tpb):
    out = A.tile_source(SOURCE, log2, tpb)
    assert re.search(rf"constexpr int kTileLog2 = {log2};", out)
    assert re.search(rf"constexpr int kTilesPerBlock = {tpb};", out)
    changed = [(a, b) for a, b in zip(SOURCE.splitlines(), out.splitlines())
               if a != b]
    assert len(changed) == 2
    assert len(out.splitlines()) == len(SOURCE.splitlines())


def test_tile_source_refuses_a_source_without_the_constants():
    with pytest.raises(ValueError, match="kTileLog2"):
        A.tile_source("constexpr int kTilesPerBlock = 32;", 15, 16)


@pytest.mark.parametrize("legs,ok", [
    (["tree", "w15t16"], True), (["pin", "tree"], True),
    (["tree", "w13t64", "pin"], True), (["tree"], False),
    (["tree", "tree"], False), (["tree", "w15"], False),
    (["fast", "tree"], False)])
def test_legs(legs, ok):
    if ok:
        assert A.parse_legs(legs) == legs
    else:
        with pytest.raises(SystemExit):
            A.parse_legs(legs)
