"""Hand-written CUDA kernels: nvcc build and ctypes loader (_build), and
the kernel wrappers with their plain PyTorch versions."""


def _wrappers():
    from genconvit_tpu_torch.ops.cuda import (block_parts, convnext_block, convnext_mlp,
                                              convnext_mlp_int8, convnext_stage, dw_moments,
                                              int8_dot, int8_matmul, window_attn)

    return {"ln_mlp_residual": convnext_mlp.ln_mlp_residual,
            "layer_norm_rows": convnext_mlp.layer_norm_rows,
            "ln_mlp_residual_int8": convnext_mlp_int8.ln_mlp_residual_int8,
            "matmul_wint8": int8_matmul.matmul_wint8,
            "fused_convnext_block": convnext_block.fused_convnext_block,
            "fused_convnext_stage": convnext_stage.fused_convnext_stage,
            "window_attention": window_attn.window_attention,
            # the probes (M1-M3): their tools launch them, no model path does
            "dots_bf16": int8_dot.dots_bf16,
            "dots_int8": int8_dot.dots_int8,
            "block_parts": block_parts.block_parts,
            "dw_moments": dw_moments.dw_moments}


def launch_counts() -> dict:
    """Kernel launches of every wrapper (K1-K7, M1-M3) since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "masked_launches"):   # K7's launches with a mask
            fn.masked_launches = 0
        if hasattr(fn, "ordered_launches"):   # K1's launches on its ordered route
            fn.ordered_launches = 0
