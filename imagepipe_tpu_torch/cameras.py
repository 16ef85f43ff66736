"""Per-camera calibration registry: model -> xyz_to_cam color matrix.

Vendor RAW containers (NEF/CR2/ARW) do not embed a colorimetric matrix the
way DNG does (ColorMatrix1); converters ship per-model tables instead (the
reference gets them from rawloader's camera database; dcraw's adobe_coeff is
the common ancestor, storing D65 XYZ->camera coefficients scaled by 10000).

This is the framework's starter table covering common benchmark bodies,
using the same x10000 integer convention so entries can be cross-checked /
extended straight from public coefficient dumps. `register_camera` lets
applications add bodies at runtime; unknown models fall back to the sRGB
matrix with a warning (image still develops, colors uncalibrated).
"""

from __future__ import annotations

import logging

import numpy as np

__all__ = ["xyz_to_cam_for", "register_camera", "register_alias",
           "register_from_dng", "register_sidecar_dir", "known_cameras"]

log = logging.getLogger(__name__)

# model (uppercased, as written in the TIFF Model tag) -> 9 ints x10000,
# row-major XYZ->cam. Starter set; extend via register_camera().
_TABLE: dict[str, tuple[int, ...]] = {
    "NIKON D850": (10405, -3755, -1270, -5461, 13787, 1793, -1040, 2015, 7037),
    "NIKON D750": (9020, -2890, -715, -4535, 12436, 2348, -934, 1919, 7086),
    "NIKON D7200": (8322, -3112, -1047, -6367, 14342, 2179, -988, 1638, 6394),
    "NIKON Z 7": (10405, -3755, -1270, -5461, 13787, 1793, -1040, 2015, 7037),
    "CANON EOS 5D MARK III": (6722, -635, -963, -4287, 12460, 2028, -908, 2162, 5668),
    "CANON EOS 5D MARK IV": (6446, -366, -864, -4436, 12204, 2513, -952, 2496, 6348),
    "CANON EOS 80D": (7457, -671, -937, -4849, 12495, 2643, -1213, 2354, 5492),
    "CANON EOS R5": (9766, -2953, -1254, -4276, 12116, 2433, -437, 1336, 5131),
    "ILCE-7M3": (7374, -2389, -551, -5435, 13162, 2519, -1006, 1795, 6552),
    "X-T2": (11434, -4948, -1210, -3746, 12042, 1903, -666, 1479, 5235),
    "X-PRO2": (11434, -4948, -1210, -3746, 12042, 1903, -666, 1479, 5235),
    "X-T30": (13426, -6334, -1177, -4244, 12136, 2371, -580, 1303, 5980),
    "ILCE-7RM3": (6640, -1847, -503, -5238, 13010, 2474, -993, 1673, 6527),
    "ILCE-7RM4": (7662, -2686, -660, -5240, 12965, 2530, -796, 1508, 6167),
    "DSC-RX100M7": (6679, -1825, -745, -5047, 13256, 1953, -1580, 2422, 5183),
}

# Bodies that share another body's sensor and published matrix (the public
# coefficient tables list identical values for each family member). Kept as
# aliases, not copies, so a correction to the base entry propagates. For
# bodies outside this table, the supported growth paths are
# register_camera() with values from the public x10000 tables, or
# register_from_dng() with the user's own Adobe-converted file -- shipping
# coefficients from memory risks exactly the silent color corruption this
# registry exists to prevent.
_ALIASES: dict[str, str] = {
    # Fujifilm X-Trans III family (shared 24MP sensor + matrix).
    "X-T20": "X-T2",
    "X-E3": "X-T2",
    "X-H1": "X-T2",
    "X100F": "X-T2",
    # Fujifilm X-Trans IV family (shared 26MP sensor + matrix).
    "X-T3": "X-T30",
    "X-T4": "X-T30",
    "X-PRO3": "X-T30",
    "X-S10": "X-T30",
    "X100V": "X-T30",
    # Nikon Z 7 shares the D850 sensor (the Z 7 entry above IS the D850
    # matrix); the II revision keeps it.
    "NIKON Z 7II": "NIKON Z 7",
    # Sony minor revisions / shared-sensor variants.
    "ILCE-7RM3A": "ILCE-7RM3",
    "ILCE-7RM4A": "ILCE-7RM4",
    "ILCE-7C": "ILCE-7M3",
    # Fujifilm X-E4 is the X-Trans IV 26MP sensor (same published matrix
    # as the rest of the family above).
    "X-E4": "X-T30",
    # Canon EOS R5 C is the R5 sensor in a cinema body (publicly stated).
    "CANON EOS R5 C": "CANON EOS R5",
}


def register_camera(model: str, coeffs) -> None:
    """Register/override a body: 9 XYZ->cam coefficients (x10000 ints or
    floats in natural units)."""
    coeffs = list(coeffs)
    assert len(coeffs) == 9
    if all(abs(c) <= 3 for c in coeffs):  # natural units -> x10000
        coeffs = [int(round(c * 10000)) for c in coeffs]
    _TABLE[model.strip().upper()] = tuple(int(c) for c in coeffs)


def register_alias(model: str, same_as: str) -> None:
    """Register a body that shares another body's sensor+matrix (public
    sensor-sharing: e.g. Nikon Z 7 / D850). The alias resolves at call
    time, so later corrections to the base entry propagate."""
    _ALIASES[model.strip().upper()] = same_as.strip().upper()


def register_from_dng(path: str, model: str | None = None) -> str:
    """Grow the registry from a DNG of the body: Adobe's converter embeds
    the colorimetric ColorMatrix1 (== xyz_to_cam) that rawloader/dcraw
    tables replicate, so a user's own converted file is verifiable
    provenance -- the documented procedure for adding bodies without
    shipping guessed constants (docs/migration: convert one shot to DNG,
    call this, then the body's native RAWs develop with calibrated color).
    Returns the model key registered."""
    from .tiff import TiffFile, T_MODEL

    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf)
    cm = tf.find(50721)       # ColorMatrix1, SRATIONALs
    if not cm or len(cm) < 9:
        raise ValueError("DNG has no ColorMatrix1 tag")
    key = (model or tf.find1(T_MODEL, "") or "").strip()
    if not key:
        raise ValueError("DNG has no Model tag; pass model= explicitly")
    register_camera(key, [float(v) for v in cm[:9]])
    return key.upper()


def register_sidecar_dir(dirpath: str) -> list[str]:
    """Batch registry growth: register_from_dng over every *.dng in a
    directory (non-recursive). The fleet-boot form of the one-shot DNG
    procedure — keep one sidecar DNG per body in a directory, call this
    once per boot (or set IMAGEPIPE_SIDECAR_DIR to have it loaded
    automatically on first matrix lookup). Per-file failures are logged
    and skipped so one corrupt sidecar can't take down the fleet.
    Returns the model keys registered."""
    import os

    registered = []
    try:
        names = sorted(os.listdir(dirpath))
    except OSError as e:
        log.warning("sidecar dir %r unreadable: %s", dirpath, e)
        return registered
    for name in names:
        if not name.lower().endswith(".dng"):
            continue
        path = os.path.join(dirpath, name)
        try:
            registered.append(register_from_dng(path))
        except Exception as e:
            log.warning("sidecar %r skipped: %s", path, e)
    if registered:
        log.info("sidecar dir %r: %d bodies registered (%s)", dirpath,
                 len(registered), ", ".join(registered))
    return registered


_SIDECAR_ENV = "IMAGEPIPE_SIDECAR_DIR"
_sidecar_loaded = False


def _load_env_sidecars_once() -> None:
    global _sidecar_loaded
    if _sidecar_loaded:
        return
    _sidecar_loaded = True
    import os

    d = os.environ.get(_SIDECAR_ENV)
    if d:
        register_sidecar_dir(d)


def known_cameras() -> list[str]:
    return sorted(set(_TABLE) | set(_ALIASES))


def _lookup(key: str):
    seen = set()
    while key in _ALIASES and key not in seen:
        seen.add(key)
        key = _ALIASES[key]
    return _TABLE.get(key)


def xyz_to_cam_from_cam2srgb(m: np.ndarray) -> np.ndarray:
    """[4,3] xyz_to_cam from a camera->sRGB-linear 3x3 (the form several
    vendors embed per file -- Olympus ImageProcessing 0x0200, and the
    dcraw `cmatrix` convention): cam->XYZ = (sRGB->XYZ) @ M, inverted.
    Per-file colorimetry with no guessed per-body constants."""
    from .color import SRGB_D65_33

    m = np.asarray(m, np.float64).reshape(3, 3)
    xyz_to_cam = np.linalg.inv(SRGB_D65_33.astype(np.float64) @ m)
    return np.concatenate([xyz_to_cam.astype(np.float32),
                           np.zeros((1, 3), np.float32)], axis=0)


def xyz_to_cam_for(make: str, model: str) -> np.ndarray:
    """[4,3] f32 xyz_to_cam for a body; sRGB identity fallback (with a
    warning) so unknown cameras still develop."""
    _load_env_sidecars_once()
    key = (model or "").strip().upper()
    entry = _lookup(key)
    if entry is None:
        # Some vendors prefix the make in the model tag or vice versa.
        longkey = f"{(make or '').strip().upper()} {key}".strip()
        entry = _lookup(longkey)
    if entry is None:
        log.warning(
            "no color matrix for %r %r; using sRGB fallback (colors "
            "uncalibrated). To calibrate: convert ONE shot from this body "
            "to DNG (Adobe DNG Converter), then run\n"
            "  python -c \"import imagepipe_tpu as ip; "
            "ip.register_from_dng('shot.dng')\"\n"
            "or drop the DNG in a sidecar directory and set %s=<dir> to "
            "auto-load it at boot (see docs/MIGRATION.md).",
            make, model, _SIDECAR_ENV)
        m = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    else:
        m = np.asarray(entry, np.float32).reshape(3, 3) / np.float32(10000.0)
    return np.concatenate([m, np.zeros((1, 3), np.float32)], axis=0)
