"""``repro_torch.live`` — mutable delta overlays over the immutable TripleStore.

See :mod:`repro_torch.live.delta` for the design.
"""

from repro_torch.live.delta import LiveStore, OverlayView

__all__ = ["LiveStore", "OverlayView"]
