"""Interactive editing on the GPU: open once, edit repeatedly, re-render fast.

Usage: python examples/torch_editor_loop.py <raw-file>

The PyTorch port's counterpart of examples/editor_loop.py. RenderService
keeps stage outputs resident on the card in a shared byte-bounded cache;
each edit recomputes only the dirty suffix of the op chain at preview
size. This is the loop a GUI (like chimper over the reference crate) would
run. `main(argv, device="cpu")` renders on the CPU.
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from imagepipe_tpu_torch.service import RenderService  # noqa: E402


def main(argv, device=None):
    if not argv:
        print("usage: torch_editor_loop.py <raw-file>", file=sys.stderr)
        return 2
    svc = RenderService(cache_bytes=2 << 30, device=device)
    svc.open_file("img", argv[0])

    t0 = time.perf_counter()
    preview = svc.render("img", max_size=1024)
    print(f"first render {1e3*(time.perf_counter()-t0):.0f} ms "
          f"({preview.width}x{preview.height})")

    edits = [
        {"basecurve": {"exposure": 0.3}},
        {"tolab": {"wb_coeffs": [2.1, 1.0, 1.4, float("nan")]}},
        {"rotatecrop": {"rotation": 0.05}},          # slight straighten
        {"basecurve": {"exposure": 0.1}},
    ]
    for patch in edits:
        t0 = time.perf_counter()
        preview = svc.edit("img", patch, max_size=1024)
        print(f"edit {list(patch)[0]:>10}: "
              f"{1e3*(time.perf_counter()-t0):.0f} ms")

    # Full-size export of the final state.
    t0 = time.perf_counter()
    full = svc.render("img", max_size=0)
    print(f"full export {1e3*(time.perf_counter()-t0):.0f} ms "
          f"({full.width}x{full.height})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
