"""Asset path resolution (twin of ti_raytrace_tpu/io/assets.py).

Looks for scene assets in $TIRAY_ASSETS if set, then <repo>/assets.
"""

import os

_REPO_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
)


def asset_path(rel: str) -> str:
    """Resolve a relative asset path like 'model/Teapot.obj'."""
    roots = []
    env = os.environ.get("TIRAY_ASSETS")
    if env:
        roots.append(env)
    roots.append(_REPO_ASSETS)
    for root in roots:
        p = os.path.join(root, rel)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"asset {rel!r} not found under any of {roots}")
