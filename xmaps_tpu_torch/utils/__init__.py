"""Host utilities: TURBO colormap data and synthetic rigs (copies of
``xmaps_tpu.utils.colormap`` and ``xmaps_tpu.utils.synthetic``)."""
