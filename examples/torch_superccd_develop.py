"""Fujifilm SuperCCD classic RAF on the GPU: develop on the diagonal
lattice, then restore square-pixel geometry.

Usage: python examples/torch_superccd_develop.py <shot.raf> [out.jpg]
       python examples/torch_superccd_develop.py --demo [out.jpg]   (synthetic)

The PyTorch port's counterpart of examples/superccd_develop.py. SuperCCD
sensors sample on a 45-degree lattice. The decoder reads classic SuperCCD
records as a plain 2x4/4x2-periodic CFA in raw coordinates
(raf.superccd_cfa), and the develop demosaics on the TRUE lattice through
the generic-CFA path, with no holed intermediate grid. The developed image
is then anisotropic: one resample by (sqrt(2), 1/sqrt(2)) --
raf.superccd_geometry, the analytic form of dcraw fuji_rotate's sqrt(0.5)
bilinear walk -- restores square pixels. `--demo` writes its synthetic RAF
to a temporary directory and the JPEG to out.jpg (default
superccd_demo.raf.jpg in the working directory). `main(argv,
device="cpu")` develops on the CPU.
"""

import os
import pathlib
import struct
import sys
import tempfile

import numpy as np
from PIL import Image

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from imagepipe_tpu_torch import Pipeline                 # noqa: E402
from imagepipe_tpu_torch import scaling                  # noqa: E402
from imagepipe_tpu_torch.buffer import OpBuffer          # noqa: E402
from imagepipe_tpu_torch.decode import decode_file       # noqa: E402
from imagepipe_tpu_torch.raf import superccd_geometry    # noqa: E402


def _make_demo(path: str) -> None:
    """Synthesize a classic SuperCCD RAF (the test builder's layout)."""
    h, w = 128, 192
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    data = (800 + 40 * np.sin(yy / 9.0) * np.cos(xx / 13.0) * 40
            + yy * 30 + rng.integers(0, 64, (h, w))).astype(np.uint16)
    recs = [
        (0x0100, struct.pack(">HH", h, w)),
        (0x0121, struct.pack(">HH", h, w)),
        (0x0130, bytes([0x00, 0x00])),      # layout 0, SuperCCD
        (0x2FF0, struct.pack(">HHHH", 302, 580, 302, 1044)),
    ]
    meta = struct.pack(">I", len(recs)) + b"".join(
        struct.pack(">HH", t, len(p)) + p for t, p in recs)
    payload = data.astype(">u2").tobytes()
    head = bytearray()
    head += b"FUJIFILMCCD-RAW "
    head += b"0201" + b"FF119412"
    head += b"FinePixS2Pro".ljust(32, b"\0") + b"0100"
    head += b"\0" * (0x54 - len(head))
    meta_off = 0x54 + 24
    head += struct.pack(">IIIIII", 0, 0, meta_off, len(meta),
                        meta_off + len(meta), len(payload))
    with open(path, "wb") as f:
        f.write(bytes(head) + meta + payload)


def main(argv, device=None):
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if argv[0] == "--demo":
        with tempfile.TemporaryDirectory() as td:
            src_path = os.path.join(td, "superccd_demo.raf")
            _make_demo(src_path)
            out = argv[1] if len(argv) > 1 else "superccd_demo.raf.jpg"
            return main([src_path, out], device)
    src_path = argv[0]
    out_path = argv[1] if len(argv) > 1 else src_path + ".jpg"

    src = decode_file(src_path)
    raw = src.raw
    layout = 1 if raw.cfa.height == 4 else 0
    print(f"{src_path}: {raw.width}x{raw.height} lattice, "
          f"CFA {raw.cfa.name} (layout {layout})")

    # 1) Develop on the true lattice (generic-CFA demosaic + color chain).
    pipe = Pipeline.new_from_source(src, device)
    lattice = pipe.output_8bit(None).data      # [h, w, 3] u8, anisotropic

    # 2) Square-pixel restore: one axis-aligned anisotropic resample.
    h, w = lattice.shape[:2]
    oh, ow = superccd_geometry(h, w, layout=layout)
    buf = OpBuffer.from_hwc(
        np.dstack([lattice.astype(np.float32) / 255.0,
                   np.zeros((h, w, 1), np.float32)]), device=pipe.device)
    data = scaling.transform_buffer_planar(
        buf.data, w, h, (0, 0), (w - 1, 0), (0, h - 1), ow, oh, 4)
    hwc = np.moveaxis(data.cpu().numpy(), 0, -1)[:, :, :3]
    out = np.clip(hwc * 255.0 + 0.5, 0, 255).astype(np.uint8)

    Image.fromarray(out).save(out_path, quality=90)
    print(f"wrote {out_path}: lattice {w}x{h} -> square-pixel {ow}x{oh}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
