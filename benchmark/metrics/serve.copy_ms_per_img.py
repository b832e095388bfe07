"""serve.copy_ms_per_img: milliseconds in which a copy between the host and
the card ran (the union of the host-to-device and device-to-host copies'
intervals) in the traced serving window, per image completed in it: the
dumper's input and readback. Moves ``img_per_s``."""

from benchmark.trace import clip, covered

HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def read(run):
    t, images = run.timeline, run.counts["images"]
    if not images:
        return None
    spans = clip(((s, e) for a, n, s, e in t.device_ops
                  if a == "gpu_memcpy" and n.startswith(HOST_COPIES)), t.start, t.end)
    return 1e3 * covered(spans) / 1e9 / images
