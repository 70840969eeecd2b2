# Hand-written Hopper kernels for the compute hot-spots the planner blocks
# (GEMM, FlashAttention forward and backward, flash-decode, the MoE grouped
# GEMM) and for the RWKV6 chunked WKV scan, forward and backward.  Each
# kernel module holds its wrapper, its launch counter and its plain PyTorch
# version; the CUDA sources are under csrc/ and are built at first use by
# _build.py; ops.py holds the public wrappers with planner-chosen tile
# shapes; ref.py the oracles; work.py each launch's operations and bytes.
#
# The kernel functions are reached through their modules
# (``kernels.gemm.gemm``, ``kernels.moe_gmm.grouped_matmul``, ...):
# re-exporting them here would shadow the modules of the same name.
from . import (flash_attention, flash_attention_bwd, flash_decode, gemm, moe_gmm, ops, ref,
               rwkv6, rwkv6_bwd, work)

__all__ = ["ops", "ref", "gemm", "flash_attention", "flash_attention_bwd", "flash_decode",
           "moe_gmm", "rwkv6", "rwkv6_bwd", "work", "launch_counts", "launches_by_body",
           "reset_launch_counts"]


def launch_counts() -> dict:
    """How often each kernel has been launched since the last reset."""
    return {"gemm": gemm.launches, "flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_decode": flash_decode.launches,
            "flash_decode_partials": flash_decode.partials_launches,
            "flash_decode_combine": flash_decode.combine_launches,
            "grouped_matmul": moe_gmm.launches, "wkv6": rwkv6.launches,
            "wkv6_bwd": rwkv6_bwd.launches}


def launches_by_body() -> dict:
    """K1's and K4's launches split by GEMM body (``"tma"``, ``"staged"``),
    K2's, K2-bwd's and K3's (both epilogues) by attention body (``"tma"``,
    ``"mma"``, ``"f32"``)."""
    return {"gemm": dict(gemm.launches_by_body),
            "grouped_matmul": dict(moe_gmm.launches_by_body),
            "flash_attention": dict(flash_attention.launches_by_body),
            "flash_attention_bwd": dict(flash_attention_bwd.launches_by_body),
            "flash_decode": dict(flash_decode.launches_by_body)}


def reset_launch_counts() -> None:
    for counts in (gemm.launches_by_body, moe_gmm.launches_by_body,
                   flash_attention.launches_by_body, flash_attention_bwd.launches_by_body,
                   flash_decode.launches_by_body):
        for body in counts:
            counts[body] = 0
    gemm.launches = 0
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    flash_decode.launches = 0
    flash_decode.partials_launches = 0
    flash_decode.combine_launches = 0
    moe_gmm.launches = 0
    rwkv6.launches = 0
    rwkv6_bwd.launches = 0
