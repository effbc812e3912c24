"""The kernels' launch plans on the CPU at the shipped widths (F 192, D 96,
hidden 96, 8 heads × 32): at 16, 17 and 21 nodes each plan function returns
the tuple its 16-, 17- and 21-node builds were designed with (rows, columns
or k-slice, stages, cluster, shared-memory bytes); for every node count from
2 to 51 each plan on the bf16 predictor path fits a block's 232 448 bytes or
raises a ValueError naming a ROADMAP item; at AMASS-MANO's 51 nodes the
fp32 engine's plans refuse (ROADMAP Queue B item 10) while B2's and K1's fit."""
import pytest
import torch

from skeletondiffusion_tpu_torch.ops.kernels import attention_proj, build, graph_linear_fused
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout, joint_attention, layer_fused
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90, resnet_block

F, D, HD, HEADS, DH, H = 192, 96, 256, 8, 32, 96
BF16, FP32 = torch.bfloat16, torch.float32

# (plan function, its arguments before the node count) of every kernel of
# the predictor paths; K1's rollout plan is fp32 on every path
PLANS = {
    "rms_qkv": lambda dt, n: attention_proj.rms_qkv_plan(dt, F, 3 * HD, n),
    "outproj_res": lambda dt, n: attention_proj.outproj_res_plan(dt, HD, F, n),
    "rms_qkv_core": lambda dt, n: layer_fused.rms_qkv_core_plan(dt, F, HEADS, DH, n),
    "stem_block": lambda dt, n: layer_fused.stem_block_plan(dt, D, F, n),
    "outproj_block": lambda dt, n: layer_fused.outproj_block_plan(dt, HD, F, n),
    "resnet_block": lambda dt, n: resnet_block.resnet_block_plan(dt, F, n),
    "final_block_in": lambda dt, n: resnet_block.final_block_in_plan(dt, F, n),
    "final_block_out": lambda dt, n: resnet_block.final_block_out_plan(dt, F, D, n),
    "graph_linear_fused": lambda dt, n: graph_linear_fused.graph_linear_fused_plan(dt, D, F, n),
    "attention_core": lambda dt, n: joint_attention.attention_plan(dt, HEADS, DH, n),
}

# The plans of the 16-, 17- and 21-node builds as their designs left them
# (whole-row kernels: rows, k-slice, stages, cluster, bytes; B3a, B9b: rows,
# columns, stages, cluster, bytes; B2: rows, heads, stages, bytes; K1: rows,
# slice, stages, cluster, bytes).
_ROW16 = {16: (16, 64, 4, 2, 211840), 17: (16, 64, 4, 2, 218368), 21: (16, 64, 3, 2, 217088)}
_QKV = {16: (32, 96, 2, 2, 196992), 17: (32, 96, 2, 2, 203264), 21: (32, 96, 2, 2, 227840)}
PINNED = {
    (n, "bf16"): {"rms_qkv": _QKV[n], "rms_qkv_core": _QKV[n],
                  **{k: _ROW16[n] for k in ("outproj_res", "stem_block", "outproj_block",
                                            "resnet_block", "final_block_in", "final_block_out",
                                            "graph_linear_fused")},
                  "attention_core": {16: (2, 8, 4, 197760), 17: (2, 8, 4, 210560),
                                     21: (2, 8, 3, 194816)}[n]}
    for n in (16, 17, 21)
}
PINNED.update({
    (16, "fp32"): {"rms_qkv": (8, 96, 2, 2, 210304), "outproj_res": (8, 64, 2, 2, 205952),
                   "rms_qkv_core": (8, 96, 2, 2, 210304), "stem_block": (8, 64, 2, 2, 208000),
                   "outproj_block": (8, 64, 2, 2, 208000), "resnet_block": (8, 64, 2, 2, 206976),
                   "final_block_in": (8, 64, 2, 2, 206976),
                   "final_block_out": (8, 64, 2, 2, 206976),
                   "graph_linear_fused": (8, 64, 2, 2, 205952),
                   "attention_core": (2, 8, 2, 197248)},
    (17, "fp32"): {"rms_qkv": (8, 96, 2, 2, 213888), "outproj_res": (8, 64, 2, 2, 212736),
                   "rms_qkv_core": (8, 96, 2, 2, 213888), "stem_block": (8, 64, 2, 2, 215424),
                   "outproj_block": (8, 64, 2, 2, 215424), "resnet_block": (8, 64, 2, 2, 214144),
                   "final_block_in": (8, 64, 2, 2, 214144),
                   "final_block_out": (8, 64, 2, 2, 214144),
                   "graph_linear_fused": (8, 64, 2, 2, 212736),
                   "attention_core": (2, 8, 2, 209792)},
    (21, "fp32"): {"rms_qkv": (8, 96, 2, 2, 226816), "outproj_res": (8, 32, 3, 2, 212992),
                   "rms_qkv_core": (8, 96, 2, 2, 226816), "stem_block": (8, 32, 3, 2, 217088),
                   "outproj_block": (8, 32, 3, 2, 217088), "resnet_block": (8, 32, 3, 2, 215040),
                   "final_block_in": (8, 32, 3, 2, 215040),
                   "final_block_out": (8, 32, 3, 2, 215040),
                   "graph_linear_fused": (8, 32, 3, 2, 212992),
                   "attention_core": (1, 8, 3, 194816)},
})
ROLLOUT = {16: (8, 32, 4, 4, 218496), 17: (8, 32, 3, 4, 206848), 21: (8, 32, 2, 4, 224240)}


@pytest.mark.parametrize("n", [16, 17, 21])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_the_designed_node_counts_keep_their_plans(n, dtype):
    dt = {"bf16": BF16, "fp32": FP32}[dtype]
    got = {name: tuple(plan(dt, n)) for name, plan in PLANS.items()}
    assert got == PINNED[(n, dtype)]
    assert tuple(gru_rollout.rollout_plan(n, H)) == ROLLOUT[n]


def test_every_node_count_up_to_51_fits_or_names_a_roadmap_item():
    """From 2 to 51 nodes every bf16 plan and K1's fit a block's shared
    memory, or raise naming the ROADMAP item (none does at F = 192)."""
    for n in range(2, build.MAX_NODES + 1):
        for name, plan in [*((k, lambda n, p=p: p(BF16, n)) for k, p in PLANS.items()),
                           ("gru_rollout", lambda n: gru_rollout.rollout_plan(n, H))]:
            try:
                smem = plan(n)[-1]
            except ValueError as e:
                assert "ROADMAP.md Queue" in str(e), (name, n, str(e))
            else:
                assert 0 < smem <= node_mix_sm90.MAX_SMEM, (name, n, smem)


def test_at_51_nodes_the_tiles_shrink_and_the_fp32_engine_refuses():
    """AMASS-MANO's tiles (csrc/node_mix.cuh::kWide): 8-row whole-row items,
    B3a 16 × 64, B9b 8 × a head's 96, B2 one row of all heads, K1 2 rows a
    block; the fp32 engine does not fit, B2's fp32 does (groups of heads)."""
    n = 51
    assert build.wide(n) and not build.wide(21)
    assert tuple(PLANS["resnet_block"](BF16, n)) == (8, 64, 2, 2, 217216)
    assert tuple(PLANS["rms_qkv"](BF16, n)) == (16, 64, 4, 2, 228352)
    assert tuple(PLANS["rms_qkv_core"](BF16, n)) == (8, 96, 3, 2, 199168)
    assert tuple(PLANS["attention_core"](BF16, n)) == (1, 8, 2, 158592)
    assert tuple(gru_rollout.rollout_plan(n, H)) == (2, 32, 2, 4, 204128)
    assert gru_rollout.rollout_plan_bytes(n, H, 2) == (
        128 + 2 * 4 * 2 * n * 96 + 4 * n * (2 * 100 + 4) + 4 * n * 4 * 2 * 32 + 12 * n * 52)
    for name, plan in PLANS.items():
        if name == "attention_core":
            assert plan(FP32, n).smem_bytes <= node_mix_sm90.MAX_SMEM
            continue
        with pytest.raises(ValueError, match="Queue B item 10"):
            plan(FP32, n)
