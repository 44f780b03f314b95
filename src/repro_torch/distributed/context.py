"""Ambient mesh context, its single-device half.

Model code calls :func:`constrain` at the points where the reference pins a
sharding, and :func:`batch_axes` where it asks which mesh axes carry the
batch.  With no mesh active both are the identity, and that is the only state
the port has so far: one card, no mesh.  Entering a mesh raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

MULTI_DEVICE_TODO = "ROADMAP queue 1 item 5 (multi-device launch)"


def current_mesh() -> Optional[object]:
    """The active mesh: always ``None`` (the port runs on one card)."""
    return None


def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh: not ported."""
    raise NotImplementedError(f"mesh_context: meshes are not ported yet: {MULTI_DEVICE_TODO}")


def frame_mesh(devices: int | None = None):
    """1-D mesh over the frame axis: not ported."""
    raise NotImplementedError(f"frame_mesh: meshes are not ported yet: {MULTI_DEVICE_TODO}")


def batch_axes() -> Tuple[str, ...]:
    """Mesh axes that carry the batch: none without a mesh."""
    return ()


def constrain(x, *spec):
    """A sharding constraint under the ambient mesh: ``x`` itself without one."""
    return x
