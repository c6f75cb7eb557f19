"""Tensor ops and the hand-written CUDA kernels of the port."""


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name: each counts its launches in
    its `launches` attribute (one where it launches its kernel on the card,
    none for its plain version)."""
    from unitspeech_tpu_torch.ops import (
        aa_snake,
        fused_attention,
        fused_resnet,
        fused_resnet_deep,
        mas,
        probes,
        resample,
        row_stats,
    )

    fns = (fused_resnet.fused_resnet_block, fused_resnet.fused_final_block,
           fused_resnet.fused_resnet_block_int8, fused_resnet.quantize_tiles,
           fused_resnet.resnet_conv3x3_i8_tiles, fused_resnet.resnet_conv3x3,
           fused_resnet.resnet_out, fused_resnet_deep.fused_resnet_block_deep,
           fused_resnet_deep.fused_resnet_block_deep_i8,
           fused_resnet_deep.fused_resnet_block_deep_int8, fused_resnet_deep.resnet_conv3x3_i8,
           row_stats.row_stats, row_stats.row_absmax, fused_attention.fused_rezero_attention,
           resample.fused_downsample_conv, resample.fused_upsample_conv,
           aa_snake.fused_aa_snake_conv, aa_snake.fused_aa_snake, probes.transcendental_chain,
           probes.row_select, probes.selection_matmul, probes.interleave_rows,
           mas.maximum_path)
    return {fn.__name__: fn for fn in fns}
