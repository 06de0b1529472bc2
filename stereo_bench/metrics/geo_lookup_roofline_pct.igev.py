"""The combined geometry-encoding lookup's share of its roofline: the
window's bound of its lookups (``lookup_bound_s``, from the family's bytes
count) over the device time of the lookup kernel's launches. A program
without the kernel gives None."""

from stereo_bench import trace

UNIT = "%"
LOOKUP = "geo_lookup_kernel"


def read(windows: list[dict]) -> float | None:
    return trace._mean([100.0 * w["lookup_bound_s"] * 1e6 / us for w in windows
                        if w.get("lookup_bound_s") and (us := sum(
                            stop - start for name, start, stop, cat in w["device"]
                            if cat == "kernel" and LOOKUP in name)) > 0])
