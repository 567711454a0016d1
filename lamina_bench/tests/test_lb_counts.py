"""The yardstick's counts against values worked out by hand at both
configurations' widths."""
import json

import pytest

from _tiny import BENCH
from lamina_bench import counts, spec


def dims(name):
    return spec.model_dims(json.loads(
        (BENCH / "configs" / f"{name}.json").read_text()))


GLM, PIX = dims("glm4-9b"), dims("pixtral-12b")


def test_parameters():
    # glm4-9b: 4096*4096 (q) + 2*4096*256 (k, v) + 4096*4096 (o)
    # + 3*4096*13696 (SwiGLU) = 203,948,032 a layer
    assert counts.layer_matmul_params(GLM) == 203_948_032
    # pixtral-12b: 2*5120*4096 + 2*5120*1024 + 3*5120*14336
    assert counts.layer_matmul_params(PIX) == 272_629_760
    total = 40 * 203_948_032 + 2 * 151_552 * 4096
    assert round(total / 1e9, 2) == 9.40
    assert round((40 * 272_629_760 + 2 * 131_072 * 5120) / 1e9, 2) == 12.25


def test_kv_bytes_a_token():
    # 40 layers x Hkv x hd x (K, V) x 2 bytes: 40 KiB and 160 KiB
    one = {"num_layers": 40, "num_heads": 32, "head_dim": 128}
    for d, kib in ((GLM, 40), (PIX, 160)):
        per_token = counts.paged_decode_bytes(d, 0, 1, 0)
        assert per_token == kib * 1024
    assert counts.attention_flops(one, 1) == 4 * 40 * 32 * 128


def test_paged_decode_bytes_by_hand():
    # B = 2 sequences of 100 and 20 cached tokens, blocks of 16: 7 + 2
    # table entries. Per layer: 120 * 2 * 128 * 2 * 2 (K, V) + 2 * 32 *
    # 128 * 2 (q) + 2 * 32 * 130 * 4 (o, l, m) + (9 + 2) * 4
    per_layer = 120 * 2 * 128 * 4 + 2 * 32 * 128 * 2 + 2 * 32 * 130 * 4 \
        + 11 * 4
    assert counts.paged_decode_bytes(GLM, 2, 120, 9) == 40 * per_layer
    assert counts.paged_decode_flops(GLM, 120) == 4 * 40 * 32 * 128 * 120


def test_causal_chunk_by_hand():
    # 3 queries after 5 cached tokens attend 6 + 7 + 8 keys
    assert counts.causal_keys(5, 3) == 21
    assert counts.paged_prefill_flops(PIX, 5, 3) == 4 * 40 * 32 * 128 * 21
    assert counts.chunk_flops(PIX, 5, 3) == (
        2 * 40 * 272_629_760 * 3 + 2 * 5120 * 131_072 +
        4 * 40 * 32 * 128 * 21)
    # bytes: (5 + 3) K/V rows of 8 heads, q and out of 3 rows of 32 heads
    assert counts.paged_prefill_bytes(PIX, 5, 3) == 40 * (
        8 * 8 * 128 * 4 + 3 * 32 * 128 * 4)


def test_decode_token_flops_by_hand():
    assert counts.decode_token_flops(GLM, 999) == (
        2 * 40 * 203_948_032 + 2 * 4096 * 151_552 +
        4 * 40 * 32 * 128 * 1000)


@pytest.mark.parametrize("flops,nbytes,bound", [
    (989e12, 1.0, 1.0), (1.0, 3.35e12, 1.0), (989e9, 3.35e9, 1e-3)])
def test_roofline_takes_the_larger_bound(flops, nbytes, bound):
    assert counts.roofline_seconds(flops, nbytes) == pytest.approx(bound)
