"""The plain reference against the port's model at float32, tiny size:
the same weights give the same logits, for a prompt (the chat cells'
check) and for tokens decoded after a given cache (the handoff cells')."""
import pytest
import torch

import _tiny
from lamina_bench import weights
from lamina_bench.reference import model as ref


@pytest.fixture
def setup():
    from repro_torch.models import transformer
    cfg = _tiny.tiny_model_config().replace(dtype=torch.float32)
    dims = dict(_tiny.TINY, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    w = weights.make_weights(dims, 11, torch.float32, "cpu")
    return transformer, cfg, dims, w


def test_prompt_logits_match_the_port(setup):
    transformer, cfg, dims, w = setup
    toks = torch.randint(0, dims["vocab_size"], (37,)).tolist()
    got = ref.forward(w, dims, [ref.Sequence_(tokens=toks, rows=[36])])[0]
    want, _ = transformer.prefill(w, cfg, {"tokens": [toks]}, max_seq=37,
                                  device="cpu")
    assert torch.allclose(got, want.float(), atol=1e-4, rtol=1e-4)


def test_decode_after_a_cache_matches_the_port(setup):
    """Tokens decoded one at a time by the port over a cache it
    prefilled equal the reference's pass over the same cache."""
    transformer, cfg, dims, w = setup
    prompt = torch.randint(0, dims["vocab_size"], (20,)).tolist()
    _, cache = transformer.prefill(w, cfg, {"tokens": [prompt]}, max_seq=32,
                                   device="cpu")
    k, v = cache["k"][:, 0, :, :20], cache["v"][:, 0, :, :20]
    toks = [5, 9, 100, 3]
    want = []
    for t in toks:
        logits, up = transformer.decode_step(w, cfg, torch.tensor([t]),
                                             cache, device="cpu")
        cache = transformer.apply_decode_updates(cache, up)
        want.append(logits[0].float())
    got = ref.forward(w, dims, [ref.Sequence_(
        tokens=toks, start=20, prefix=lambda i: (k[i], v[i]))])[0]
    assert torch.allclose(got, torch.stack(want), atol=1e-4, rtol=1e-4)


def test_control_is_a_lower_precision(setup):
    """The float8 control moves the logits by far more than float32
    rounding does."""
    _, _, dims, w = setup
    toks = list(range(40))
    s = [ref.Sequence_(tokens=toks)]
    a, b = ref.forward(w, dims, s)[0], ref.forward(w, dims, s, "fp8")[0]
    assert (a - b).abs().max() > 1e-2
