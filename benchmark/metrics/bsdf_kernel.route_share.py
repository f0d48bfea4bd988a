"""bsdf_kernel.route_share: the share of the Disney BSDF's dispatches in
the device-profiled calls that took the hand kernel (csrc/disney.cu):
the program's `bsdf.disney` spans with route "kernel" over all of them.
None where the program records no such span (an older commit)."""

from harness import spans


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    routes = [r.attrs.get("route") for r in records if r.name == "bsdf.disney"]
    if not routes:
        return None
    return sum(route == "kernel" for route in routes) / len(routes)
