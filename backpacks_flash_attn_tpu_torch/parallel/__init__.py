"""Parallel training over ``torch.distributed``: the (data, seq) mesh, the
launcher of a world of ranks, ring attention and context-parallel
training (ports of ``backpacks_flash_attn_tpu/parallel/``)."""
