"""order_kernel.route_share: the share of the cluster tracer's coherence
sort-key spans in the device-profiled calls that took the hand kernel
(ti_raytrace_tpu_torch/csrc/coherence_key.cu): the program's `trace.order`
spans with route "kernel" over all of them that carry a route.  None where
the program records no such span, or none with a route (an older commit)."""

from harness import spans


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    routes = [r.attrs.get("route") for r in records if r.name == "trace.order"]
    routes = [route for route in routes if route is not None]
    if not routes:
        return None
    return sum(route == "kernel" for route in routes) / len(routes)
