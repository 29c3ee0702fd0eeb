"""The yardstick's FLOPs and bytes against hand counts."""
import math

import pytest

import smoke  # noqa: F401
from benchlib import weights, work


def test_causal_pairs_by_hand():
    assert work.causal_pairs(4, 4) == 1 + 2 + 3 + 4
    assert work.causal_pairs(4, 4, window=2) == 1 + 2 + 2 + 2
    assert work.causal_pairs(2, 5) == 4 + 5
    for sq, sk in ((1, 1), (3, 3), (3, 8), (7, 7)):
        assert work.causal_pairs(sq, sk) == sum(
            sk - sq + i + 1 for i in range(sq))


def test_attention_call_by_hand():
    # B 1, S 4, 2 query heads over 1 KV head of 8: 10 causal pairs
    flops, nbytes = work.attention_call((1, 4, 2, 8), (1, 4, 1, 8))
    assert flops == 2 * 2 * (1 * 2 * 8) * 10
    assert nbytes == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)
    full, _ = work.attention_call((1, 4, 2, 8), (1, 4, 1, 8), causal=False)
    assert full == 2 * 2 * (1 * 2 * 8) * 16


def test_decode_call_by_hand():
    # B 2, 4 query heads over 2 KV heads of 8, keys 0 .. 9 of 16
    flops, nbytes = work.decode_call((2, 4, 8), (2, 16, 2, 8), 9)
    assert flops == 4 * 2 * 4 * 8 * 10
    assert nbytes == 2 * (2 * 2 * 4 * 8) + 2 * (2 * 2 * 2 * 10 * 8)
    _, windowed = work.decode_call((2, 4, 8), (2, 16, 2, 8), 9, window=4)
    assert windowed == 2 * (2 * 2 * 4 * 8) + 2 * (2 * 2 * 2 * 4 * 8)


@pytest.mark.parametrize("config", ["granite-moe-3b-a800m", "qwen2-7b"])
def test_parameter_count_is_the_ports(bench, config):
    from repro_torch.configs import get_config
    c = bench.config_file(config)
    leaves = sum(math.prod(s.shape) for s in weights.leaf_specs(c))
    assert work.n_params(c) == leaves == get_config(c["arch"]).n_params()


def test_train_step_by_hand():
    # one layer, D 8, 2 heads of 4 over 1 KV head, d_ff 16, vocab 32
    c = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
         "head_dim": 4, "intermediate_size": 16, "vocab_size": 32,
         "num_hidden_layers": 1, "attention_bias": False,
         "tie_word_embeddings": False, "param_dtype": "bfloat16",
         "opt_dtype": "float32", "cache_dtype": "bfloat16"}
    matrices = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16      # a token's
    flops, nbytes = work.train_step(c, 2, 4)
    assert flops == 6 * (matrices + 8 * 32) * 8 + 3 * 4 * 2 * 2 * 4 * 10
    P = 32 * 8 * 2 + (matrices + 2 * 8) + 8
    assert work.n_params(c) == P
    assert nbytes == 28 * P
    pf, _ = work.prefill(c, 4)
    assert pf == 2 * matrices * 4 + 4 * 2 * 4 * 10 + 2 * 8 * 32


def test_prefill_against_the_dry_run(bench):
    """The port's dry run of qwen2-7b's 1 x 32768 prefill
    counts every (query, key) pair; with all pairs the yardstick gives the
    same number, and causality leaves about half of attention's."""
    c = bench.config_file("qwen2-7b")
    S = 32768
    causal, _ = work.prefill(c, S)
    full_attn, _ = work.attention_call((1, S, 28, 128), (1, S, 4, 128),
                                       causal=False)
    causal_attn, _ = work.attention_call((1, S, 28, 128), (1, S, 4, 128))
    all_pairs = causal - 28 * causal_attn + 28 * full_attn
    assert all_pairs == 858_650_951_811_072
    assert causal == 858_650_951_811_072 - 28 * (full_attn - causal_attn)
