# Hand-written Hopper kernels for the compute hot-spots the planner blocks
# (GEMM, FlashAttention forward, flash-decode, the MoE grouped GEMM).  Each
# kernel module holds its wrapper, its launch counter and its plain PyTorch
# version; the CUDA sources are under csrc/ and are built at first use by
# _build.py; ops.py holds the public wrappers with planner-chosen tile
# shapes; ref.py the oracles.
#
# The kernel functions are reached through their modules
# (``kernels.gemm.gemm``, ``kernels.moe_gmm.grouped_matmul``, ...):
# re-exporting them here would shadow the modules of the same name.
from . import flash_attention, flash_decode, gemm, moe_gmm, ops, ref

__all__ = ["ops", "ref", "gemm", "flash_attention", "flash_decode", "moe_gmm",
           "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict:
    """How often each kernel has been launched since the last reset."""
    return {"gemm": gemm.launches, "flash_attention": flash_attention.launches,
            "flash_decode_partials": flash_decode.partials_launches,
            "flash_decode_combine": flash_decode.combine_launches,
            "grouped_matmul": moe_gmm.launches}


def reset_launch_counts() -> None:
    gemm.launches = 0
    flash_attention.launches = 0
    flash_decode.partials_launches = 0
    flash_decode.combine_launches = 0
    moe_gmm.launches = 0
