"""Layer "embed": the share of the rows the backbone ran in the window that
were batch padding, from the program's counters (``IMAGES_EMBEDDED``, the
rows run, padding included, and ``IMAGES_DECODED``, the images decoded)
read before and after the window (``harness/spans.py counted``).  A count:
it repeats exactly."""


def read(w):
    embedded = w.work.get("images_embedded", 0)
    decoded = w.work.get("images_decoded", 0)
    if embedded <= 0 or decoded <= 0:
        return None
    return 100.0 * (embedded - decoded) / embedded
