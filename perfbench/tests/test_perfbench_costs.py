"""The benchmark's own byte and FLOP counts against hand-worked
values."""
import json
import os

from perfbench.harness import costs
from perfbench.harness.spec import BENCH_DIR
from perfbench.reference.sizes import Sizes


def _sizes(name):
    with open(os.path.join(BENCH_DIR, 'configs', name + '.json')) as f:
        return Sizes.from_hf(json.load(f)['config'])


def test_qwen2_7b():
    s = _sizes('qwen2-7b')
    # embed + unembed 2 x 152064 x 3584; per layer wq, wo 3584^2, wk, wv
    # 3584 x 512, three 3584 x 18944 FFN matrices; biases 4608 and norms
    # 7168 a layer; the final norm 3584.
    assert costs.param_count(s) == 7_615_616_512
    assert costs.param_bytes(s) == 15_230_566_400 + 1_333_248   # 15.23 GB
    assert costs.kv_bytes_per_token(s) == 57_344                # 2x28x4x128x2
    assert costs.token_matmul_flops(s) == 2 * 7_070_285_824
    assert costs.token_matmul_flops(s, unembed=False) == 2 * 6_525_288_448


def test_mixtral_8x7b_16_layers():
    s = _sizes('mixtral-8x7b-16l')
    # 16 x (41,943,040 attention + 32,768 router + 8 x 176,160,768
    # experts) + 2 x 32000 x 4096 embeddings = 23.48 B matrices.
    matrices = 16 * 1_451_261_952 + 262_144_000
    vectors = 16 * 2 * 4096 + 4096
    assert costs.param_count(s) == matrices + vectors
    assert costs.param_bytes(s) == 46_964_670_464 + vectors * 4  # 46.96 GB
    assert costs.kv_bytes_per_token(s) == 65_536                # 2x16x8x128x2
    # a token passes through two experts: 16 x 394,297,344 + unembed.
    assert costs.token_matmul_flops(s) == 2 * (16 * 394_297_344
                                               + 131_072_000)


def test_causal_attention_flops():
    s = _sizes('qwen2-7b')
    one = costs.attention_flops(s, 1)
    assert one == 4 * 28 * 28 * 128
    assert costs.attention_flops_span(s, 0, 3) == one * (1 + 2 + 3)
    assert costs.attention_flops_span(s, 10, 2) == one * (11 + 12)
