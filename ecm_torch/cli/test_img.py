"""Single-pair demo (port of ``ecm_tpu/cli/test_img.py``, the reference's
``test_img.py``): one stereo pair from files, or a synthetic one with
``--synthetic``, to a 16-bit disparity PNG and a colour-mapped view beside
it (``<out>_vis.png``). With ``--multihost`` every rank computes the pair and
rank 0 writes it.

    python -m ecm_torch.cli.test_img --left l.png --right r.png --out disp.png
    python -m ecm_torch.cli.test_img --synthetic --out disp.png
"""

from __future__ import annotations

import numpy as np
import torch

from ecm_torch.cli.common import (
    base_parser,
    build_state,
    maybe_init_distributed,
    resolve_config,
    restore,
    say,
    shutdown_distributed,
)
from ecm_torch.data.kitti import save_disp_png
from ecm_torch.data.preprocess import normalize, pad_to_multiple, unpad
from ecm_torch.parallel import is_main_process
from ecm_torch.train.steps import make_infer_fn


def colormap_png(path: str, disp: np.ndarray) -> None:
    """Turbo-like colour-mapped disparity, written with Pillow."""
    from PIL import Image

    d = disp / max(float(disp.max()), 1e-6)
    r = np.clip(1.5 - np.abs(2.0 * d - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * d - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * d - 0.5), 0, 1)
    rgb = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(path)


def main(argv: list[str] | None = None) -> None:
    parser = base_parser("ecm_torch single-pair demo (reference test_img.py)")
    parser.add_argument("--left", default=None)
    parser.add_argument("--right", default=None)
    parser.add_argument("--out", default="disp.png")
    parser.add_argument("--synthetic", action="store_true")
    args = parser.parse_args(argv)
    maybe_init_distributed(args)
    cfg = resolve_config(args, default_preset="kitti_infer")

    if not args.synthetic and not (args.left and args.right):
        parser.error("--left/--right or --synthetic required")
    state, _ = restore(build_state(cfg, args.device, 0), args.loadmodel)
    if args.synthetic:
        from ecm_torch.data.synthetic import make_pair

        s = make_pair(np.random.default_rng(0), h=256, w=512, max_disp=40.0)
        left_n, right_n, gt = s["left"], s["right"], s["disparity"]
        pads = (0, 0)
    else:
        from ecm_torch.data.sceneflow import read_rgb

        # the model's own input multiple where it has one (IGEV-Stereo: 32)
        multiple = getattr(state.model, "input_multiple", 16)
        left_n, pads = pad_to_multiple(normalize(read_rgb(args.left)), multiple=multiple)
        right_n, _ = pad_to_multiple(normalize(read_rgb(args.right)), multiple=multiple)
        gt = None

    device = next(state.model.parameters()).device
    infer = make_infer_fn(state.model)
    left, right = (torch.from_numpy(a)[None].to(device) for a in (left_n, right_n))
    disp = infer(left, right)[0].float().cpu().numpy()
    disp = unpad(disp, pads)
    if is_main_process():
        save_disp_png(args.out, disp)
        colormap_png(args.out.replace(".png", "_vis.png"), disp)
    msg = f"wrote {args.out}: range [{disp.min():.2f}, {disp.max():.2f}]"
    if gt is not None:
        valid = gt > 0
        msg += f", EPE vs synthetic GT: {np.abs(disp - gt)[valid].mean():.3f} px"
    say(msg)
    shutdown_distributed()


if __name__ == "__main__":
    main()
