"""Host-side geodesy helpers (GDAL-free)."""

from dsen2_tpu_torch.geo.utm import utm_forward, utm_inverse, zone_from_epsg

__all__ = ["utm_forward", "utm_inverse", "zone_from_epsg"]
