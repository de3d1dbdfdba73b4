"""Command line of the port (counterpart of `veon_tpu/cli/main.py`): the
`serve` subcommand. `text_classifier`, the counterpart of the reference's
`_text_classifier`, lives in `nn/text.py` and is re-exported here.

    python -m veon_tpu_torch.cli.main serve --preset veon_b \
        --socket /tmp/veon.sock [--num-temporal 2] [--raw-uint8] \
        [--bpe-path bpe_simple_vocab_16e6.txt.gz]

The server answers `serve/client.py` `TensorClient` (and the JAX
package's python and C++ clients): F=1 requests carry imgs and
depth_imgs, streaming requests (--num-temporal > 1) one frame each plus
lidarego2global; either may add text_embed (C,) or text_tokens (1, 77)
int32 for a free-text `retrieval` map. Weights are seeded stand-ins here;
`entry.serve_entry` takes JAX variables and text-tower params.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from ..configs import presets
from ..entry import serve_entry
from ..nn.text import text_classifier  # noqa: F401  (the CLI's `_text_classifier`)
from ..serve.server import TensorServer


def build_cfg(args):
    """The preset named by args with its frame count, computing in bf16 as
    every entry of the port does (`entry.serve_entry`'s default)."""
    cfg = getattr(presets, args.preset)(num_temporal=args.num_temporal)
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


def build_serve_handler(args):
    """(handler, required request keys, expectation string, exclusive) for
    `cmd_serve`, built by `entry.serve_entry`; split out so tests and
    `chip_smoke.py` mount the handler on their own `TensorServer`."""
    if getattr(args, "cam_shards", 1) > 1:
        raise NotImplementedError("camera-sharded serving (--cam-shards > 1) is not ported "
                                  "yet: ROADMAP Queue 1 item 16")
    if getattr(args, "load_from", None) or getattr(args, "depth_load_from", None):
        raise NotImplementedError("loading the reference's PyTorch checkpoints (--load-from, "
                                  "--depth-load-from) is not ported yet (ROADMAP Queue 1); "
                                  "pass JAX variables to entry.serve_entry")
    return serve_entry(build_cfg(args), device=args.device, bpe_path=args.bpe_path,
                       raw_uint8=args.raw_uint8)


def cmd_serve(args):
    """Bind the model, rig precompute and classifier on the device and
    answer requests over a unix socket until interrupted."""
    handler, required, expect, exclusive = build_serve_handler(args)
    srv = TensorServer(handler, args.socket, required=required, exclusive=exclusive)
    srv.start()
    print(f"serving on {args.socket} ({expect}); ctrl-c to stop", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


def parser() -> argparse.ArgumentParser:
    """The command line: `serve` and its options."""
    ap = argparse.ArgumentParser(prog="veon_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("serve")
    p.add_argument("--preset", default="veon_b")
    p.add_argument("--num-temporal", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    p.add_argument("--socket", default="/tmp/veon_serve.sock", help="unix socket path")
    p.add_argument("--bpe-path", default=None,
                   help="CLIP bpe_simple_vocab_16e6.txt.gz for exact tokenization")
    p.add_argument("--raw-uint8", action="store_true",
                   help="accept raw uint8 RGB frames and normalize them on the device")
    p.add_argument("--cam-shards", type=int, default=1, help="not ported: must be 1")
    p.add_argument("--load-from", default=None, help="not ported: reference SAN/VEON .pth")
    p.add_argument("--depth-load-from", default=None, help="not ported: reference depth .pth")
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
