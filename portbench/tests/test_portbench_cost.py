"""The cost arithmetic against counts made by hand."""

import json

import pytest
import torch
from conftest import REPO

from portbench.lib import cost


def _conf(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def test_dlrm_forward_flops_by_hand():
    conf = _conf("dlrm-kaggle-qr4")
    bottom = 13 * 512 + 512 * 256 + 256 * 64 + 64 * 16
    top = 367 * 512 + 512 * 256 + 256 * 1
    dots = 351 * 16
    assert (bottom, top, dots) == (155_136, 319_232, 5_616)
    assert cost.dlrm_forward_flops(conf) == 2 * 479_984 == 959_968


def test_dcn_forward_flops_by_hand():
    conf = _conf("dcn-kaggle-qr4")
    assert cost.dcn_x0(conf) == 13 + 26 * 16 == 429
    cross = 6 * (429 + 429)                       # x · w and x0 · s per layer
    deep = 429 * 512 + 512 * 256 + 256 * 64
    out = 429 + 64
    assert cross + deep + out == 372_745
    assert cost.dcn_forward_flops(conf) == 745_490


def test_interact_bytes_and_flops_by_hand():
    conf = _conf("dlrm-kaggle-qr4")
    # z (16) and 26 features (416) in, the top MLP's input (16 + 351) out, f32
    assert cost.interact_bytes(conf, 1) == 4 * (16 + 416 + 367) == 3_196
    assert cost.interact_bytes(conf, 1000) == 3_196_000
    assert cost.interact_flops(conf, 1) == 2 * 351 * 16


@pytest.mark.parametrize("stored, width", [("int8", 19), ("float32", 64)])
def test_row_bytes(stored, width):
    assert cost.row_bytes(16, stored) == width


def test_distinct_rows_count_each_live_row_once():
    # table 0: m = 3 (remainder rows 0..2, quotient rows 0..); table 1 full
    sparse = torch.tensor([[0, 5], [3, 5], [4, 7], [3, 5]], dtype=torch.int32)
    # table 0 ids 0, 3, 4, 3: remainders {0, 1}, quotients {0, 1}; table 1: {5, 7}
    assert cost.distinct_rows(sparse, [3, None]) == 2 + 2 + 2


def test_embed_bytes_by_hand():
    conf = {"emb_dim": 16, "table_sizes": [10, 8]}
    sparse = torch.tensor([[0, 5], [3, 5], [4, 7], [3, 5]], dtype=torch.int32)
    ids, out = 4 * 2 * 4, 4 * 2 * 16 * 4
    assert cost.embed_bytes(conf, sparse, [3, None], "int8") == ids + 6 * 19 + out
    assert cost.embed_flops(conf, 4) == 4 * 2 * 16 * 5
