"""The whole step's share of the card's bf16 peak, in percent: the model
FLOPs of the window's decoded tokens and prefill chunks (from shapes,
``counts``) over the window's host seconds times 989 TFLOP/s."""
from lamina_bench import counts


def read(w):
    if not w.steps or w.window_s <= 0:
        return None
    m = w.dims
    per_token = (2 * m["num_layers"] * counts.layer_matmul_params(m) +
                 2 * m["d_model"] * m["vocab_size"])
    flops = 0
    for s in w.steps:
        flops += s.decoded * per_token + counts.attention_flops(
            m, s.ctx_sum + s.decoded)
        flops += sum(counts.chunk_flops(m, start, n) for start, n in s.chunks)
    return 100.0 * flops / (w.window_s * counts.H100_BF16_FLOPS)
