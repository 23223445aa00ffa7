"""Layer "sweep" (``pipeline.run_category_sweep`` and the host's dispatch):
kernels launched on the card in the traced window per test image whose
(alpha, X) reached the host.  A count: it repeats exactly."""


def read(w):
    images = w.work.get("test_images", 0)
    if images <= 0 or w.n_kernels <= 0:
        return None
    return w.n_kernels / images
