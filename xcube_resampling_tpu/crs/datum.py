"""Reference ellipsoids / datums for the native CRS engine.

The reference library delegates all geodesy to the PROJ C library via pyproj
(reference: /root/reference/xcube_resampling/gridmapping/base.py:49-52,
reproject.py:124-126).  This rebuild implements the projection math natively
so coordinate transforms are pure array functions that run under ``jax.jit``
on the device — the transform step becomes part of the fused device kernel instead
of a host-side staging pass.

Datum note: ETRS89 and WGS84 are treated as coincident (their offset is
< 1 m and drifting; PROJ's default ballpark transformation does the same),
so the geographic hub of a transform pipeline is a shared (lon, lat).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Ellipsoid:
    name: str
    a: float  # semi-major axis [m]
    inverse_flattening: float  # 1/f, 0 => sphere

    @property
    def f(self) -> float:
        return 1.0 / self.inverse_flattening if self.inverse_flattening else 0.0

    @property
    def b(self) -> float:
        return self.a * (1.0 - self.f)

    @property
    def e2(self) -> float:
        f = self.f
        return f * (2.0 - f)

    @property
    def e(self) -> float:
        return self.e2**0.5

    @property
    def n(self) -> float:
        """Third flattening."""
        f = self.f
        return f / (2.0 - f)


WGS84 = Ellipsoid("WGS 84", 6378137.0, 298.257223563)
GRS80 = Ellipsoid("GRS 1980", 6378137.0, 298.257222101)
SPHERE = Ellipsoid("Normal Sphere", 6370997.0, 0.0)
INTL1924 = Ellipsoid("International 1924", 6378388.0, 297.0)
CLARKE1866 = Ellipsoid("Clarke 1866", 6378206.4, 294.978698213898)
BESSEL1841 = Ellipsoid("Bessel 1841", 6377397.155, 299.1528128)
AIRY1830 = Ellipsoid("Airy 1830", 6377563.396, 299.3249646)
KRASSOWSKY1940 = Ellipsoid("Krassowsky 1940", 6378245.0, 298.3)
WGS72 = Ellipsoid("WGS 72", 6378135.0, 298.26)

ELLIPSOIDS = {
    e.name: e
    for e in (
        WGS84,
        GRS80,
        SPHERE,
        INTL1924,
        CLARKE1866,
        BESSEL1841,
        AIRY1830,
        KRASSOWSKY1940,
        WGS72,
    )
}


def ellipsoid_from_params(
    semi_major_axis: float | None = None,
    inverse_flattening: float | None = None,
    semi_minor_axis: float | None = None,
    reference_ellipsoid_name: str | None = None,
) -> Ellipsoid:
    """Build an ellipsoid from CF grid-mapping attributes."""
    if reference_ellipsoid_name and reference_ellipsoid_name in ELLIPSOIDS:
        return ELLIPSOIDS[reference_ellipsoid_name]
    if semi_major_axis is None:
        return WGS84
    a = float(semi_major_axis)
    if inverse_flattening is not None:
        rf = float(inverse_flattening)
    elif semi_minor_axis is not None and semi_minor_axis != a:
        rf = a / (a - float(semi_minor_axis))
    else:
        rf = 0.0
    for known in (WGS84, GRS80):
        if abs(known.a - a) < 1e-6 and abs(known.inverse_flattening - rf) < 1e-6:
            return known
    return Ellipsoid("unnamed", a, rf)


# ---------------------------------------------------------------------------
# datum transforms (7-parameter Helmert via the geocentric hub)
# ---------------------------------------------------------------------------

#: Normalized datum name -> 7-parameter towgs84 transform
#: (tx, ty, tz [m], rx, ry, rz [arc-sec, position-vector convention],
#: ds [ppm]).  The modern realizations (WGS84 / ETRS89 / NAD83 / RGF93 /
#: GDA94/2020 ...) are treated as coincident, matching PROJ's default
#: ballpark behavior (their true offsets are < 1 m and time-dependent).
#: Legacy datums use the EPSG single-Helmert (mean-value) parameters —
#: regionally accurate to a few metres, like PROJ without grid files.
_ZERO7 = (0.0,) * 7

TOWGS84_BY_DATUM = {
    "world_geodetic_system_1984": _ZERO7,
    "world_geodetic_system_1984_ensemble": _ZERO7,
    "wgs_84": _ZERO7,
    "wgs84": _ZERO7,
    "d_wgs_1984": _ZERO7,
    "european_terrestrial_reference_system_1989": _ZERO7,
    "european_terrestrial_reference_system_1989_ensemble": _ZERO7,
    "etrs89": _ZERO7,
    "north_american_datum_1983": _ZERO7,
    "nad83": _ZERO7,
    "reseau_geodesique_francais_1993": _ZERO7,
    "reseau_geodesique_francais_1993_v1": _ZERO7,
    "rgf93": _ZERO7,
    "geocentric_datum_of_australia_1994": _ZERO7,
    "geocentric_datum_of_australia_2020": _ZERO7,
    # legacy datums (EPSG mean-value Helmert parameters)
    "european_datum_1950": (-87.0, -98.0, -121.0, 0.0, 0.0, 0.0, 0.0),
    "ed50": (-87.0, -98.0, -121.0, 0.0, 0.0, 0.0, 0.0),
    "osgb_1936": (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489),
    "osgb36": (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489),
    "ordnance_survey_of_great_britain_1936": (
        446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489,
    ),
    "tokyo": (-146.414, 507.337, 680.507, 0.0, 0.0, 0.0, 0.0),
    "deutsches_hauptdreiecksnetz": (598.1, 73.7, 418.2, 0.202, 0.045, -2.455, 6.7),
    "dhdn": (598.1, 73.7, 418.2, 0.202, 0.045, -2.455, 6.7),
    "potsdam": (598.1, 73.7, 418.2, 0.202, 0.045, -2.455, 6.7),
    "north_american_datum_1927": (-8.0, 160.0, 176.0, 0.0, 0.0, 0.0, 0.0),
    "nad27": (-8.0, 160.0, 176.0, 0.0, 0.0, 0.0, 0.0),
    "pulkovo_1942": (23.92, -141.27, -80.9, 0.0, 0.35, 0.82, -0.12),
    # EPSG 15934 (Amersfoort to ETRS89), the RD New datum
    "amersfoort": (
        565.4171, 50.3319, 465.5524, -0.398957, 0.343988, -1.8774, 4.0725,
    ),
    "hartebeesthoek94": _ZERO7,
    # EPSG 15929 (BD72 to WGS 84 (3)), the Belgian Lambert 72 datum
    "reseau_national_belge_1972": (
        -106.8686, 52.2978, -103.7239, 0.3366, -0.457, 1.8422, -1.2747,
    ),
    "belge_1972": (
        -106.8686, 52.2978, -103.7239, 0.3366, -0.457, 1.8422, -1.2747,
    ),
    "world_geodetic_system_1972": (0.0, 0.0, 4.5, 0.0, 0.0, 0.554, 0.2263),
    "wgs_72": (0.0, 0.0, 4.5, 0.0, 0.0, 0.554, 0.2263),
}


#: spelling variants (WKT1/ESRI/proj4 datum names) -> canonical key
_DATUM_ALIASES = {
    "wgs_1984": "world_geodetic_system_1984",
    "wgs84": "world_geodetic_system_1984",
    "wgs_84": "world_geodetic_system_1984",
    "d_wgs_1984": "world_geodetic_system_1984",
    "world_geodetic_system_1984_ensemble": "world_geodetic_system_1984",
    "etrs89": "european_terrestrial_reference_system_1989",
    "etrs_1989": "european_terrestrial_reference_system_1989",
    "d_etrs_1989": "european_terrestrial_reference_system_1989",
    "european_terrestrial_reference_system_1989_ensemble": (
        "european_terrestrial_reference_system_1989"
    ),
    "nad83": "north_american_datum_1983",
    "d_north_american_1983": "north_american_datum_1983",
    "nad27": "north_american_datum_1927",
    "d_north_american_1927": "north_american_datum_1927",
    "ed50": "european_datum_1950",
    "d_european_1950": "european_datum_1950",
    "osgb36": "osgb_1936",
    "ordnance_survey_of_great_britain_1936": "osgb_1936",
    "d_osgb_1936": "osgb_1936",
    "rgf93": "reseau_geodesique_francais_1993",
    "reseau_geodesique_francais_1993_v1": "reseau_geodesique_francais_1993",
    "dhdn": "deutsches_hauptdreiecksnetz",
    "potsdam": "deutsches_hauptdreiecksnetz",
    "wgs_72": "world_geodetic_system_1972",
    "wgs72": "world_geodetic_system_1972",
}


def normalize_datum_name(name: str) -> str:
    import re

    return re.sub(r"[^a-z0-9]+", "_", str(name).lower()).strip("_")


def canonical_datum_key(name: str) -> str:
    """Normalized datum identifier with spelling variants collapsed, so
    WKT1 'WGS_1984', WKT2 '... ensemble' and plain 'WGS 84' all compare
    equal."""
    n = normalize_datum_name(name)
    return _DATUM_ALIASES.get(n, n)


def towgs84_for_datum(name: str):
    """Known 7-parameter transform for a datum name, or None."""
    return TOWGS84_BY_DATUM.get(canonical_datum_key(name))


def geodetic_to_geocentric(lon_deg, lat_deg, ell: Ellipsoid, xp):
    """(lon, lat) degrees on *ell* (h = 0) -> geocentric (X, Y, Z) metres.
    Pure array math — runs on numpy float64 or traces under jax.jit."""
    d2r = 0.017453292519943295
    lon = lon_deg * d2r
    lat = lat_deg * d2r
    sphi = xp.sin(lat)
    cphi = xp.cos(lat)
    nu = ell.a / xp.sqrt(1.0 - ell.e2 * sphi * sphi)
    x = nu * cphi * xp.cos(lon)
    y = nu * cphi * xp.sin(lon)
    z = nu * (1.0 - ell.e2) * sphi
    return x, y, z


def geocentric_to_geodetic(x, y, z, ell: Ellipsoid, xp):
    """Geocentric (X, Y, Z) metres -> (lon, lat) degrees on *ell* (h
    discarded), via Bowring's method with one refinement iteration
    (sub-micrometre for earth-surface points)."""
    r2d = 57.29577951308232
    p = xp.sqrt(x * x + y * y)
    e2 = ell.e2
    b = ell.b
    ep2 = (ell.a * ell.a - b * b) / (b * b) if b else 0.0
    theta = xp.arctan2(z * ell.a, p * b)
    st = xp.sin(theta)
    ct = xp.cos(theta)
    lat = xp.arctan2(z + ep2 * b * st * st * st, p - e2 * ell.a * ct * ct * ct)
    # one Bowring refinement of the parametric latitude
    theta = xp.arctan2((1.0 - ell.f) * xp.sin(lat), xp.cos(lat))
    st = xp.sin(theta)
    ct = xp.cos(theta)
    lat = xp.arctan2(z + ep2 * b * st * st * st, p - e2 * ell.a * ct * ct * ct)
    lon = xp.arctan2(y, x)
    return lon * r2d, lat * r2d


def helmert7(x, y, z, p7, xp, inverse: bool = False):
    """7-parameter Helmert transform, position-vector rotation convention
    (EPSG 9606, PROJ +towgs84): X2 = T + (1 + s) R X with the small-angle
    rotation matrix.  ``inverse=True`` applies the exact-to-first-order
    reverse (standard for towgs84 round trips)."""
    tx, ty, tz, rx_s, ry_s, rz_s, ds = p7
    as2r = 4.84813681109536e-06  # arc-seconds -> radians
    rx = rx_s * as2r
    ry = ry_s * as2r
    rz = rz_s * as2r
    m = 1.0 + ds * 1e-6
    if not inverse:
        x2 = m * (x - rz * y + ry * z) + tx
        y2 = m * (rz * x + y - rx * z) + ty
        z2 = m * (-ry * x + rx * y + z) + tz
        return x2, y2, z2
    xs = (x - tx) / m
    ys = (y - ty) / m
    zs = (z - tz) / m
    x2 = xs + rz * ys - ry * zs
    y2 = -rz * xs + ys + rx * zs
    z2 = ry * xs - rx * ys + zs
    return x2, y2, z2
