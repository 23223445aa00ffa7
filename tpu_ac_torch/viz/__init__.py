"""Offline analysis / visualization layer (port of ``tpu_ac.viz``).

Rebuilds Anomaly-Clustering/utils/{draw.py,draw_alpha.py}, the
examples/test.py ``visualize`` helper, dino-main/visualize_attention.py,
and the segmentation-image plotter (models/patchcore/utils.py:18-77).
"""

from tpu_ac_torch.viz.plots import (
    draw_metrics,
    read_results_csv,
    alpha_heatmap,
    visualize_alpha_on_image,
    plot_segmentation_images,
    attention_maps,
)

__all__ = [
    "draw_metrics",
    "read_results_csv",
    "alpha_heatmap",
    "visualize_alpha_on_image",
    "plot_segmentation_images",
    "attention_maps",
]
