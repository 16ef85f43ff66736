"""converter CLI: develop any image file to JPEG.

Counterpart of `imagepipe_tpu/cli.py` (the reference's
src/bin/converter.rs): `python -m imagepipe_tpu_torch.cli <file>
[outfile]` -> quality-90 JPEG, default outfile `<file>.jpg`; exit 1 on
usage error, exit 2 on processing error (no CUDA device included).
Develops on the first CUDA device; `main(argv, device="cpu")` develops on
the CPU.
"""

from __future__ import annotations

import sys


def main(argv=None, device=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        print("converter <file> [outfile]")
        return 1
    file = argv[1]
    outfile = argv[2] if len(argv) > 2 else f"{file}.jpg"
    print(f'Loading file "{file}" and saving it as "{outfile}"')

    try:
        from . import simple_decode_8bit

        decoded = simple_decode_8bit(file, 0, 0, device)
        from PIL import Image

        Image.fromarray(decoded.data).save(outfile, format="JPEG", quality=90)
    except Exception as e:
        print(f"ERROR: {e}")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
