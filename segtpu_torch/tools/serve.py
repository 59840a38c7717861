"""Serve an exported segtpu_torch artifact over HTTP.

Usage: python -m segtpu_torch.tools.serve ARTIFACT_DIR [--host H]
    [--port P] [--device cuda|cpu] [--tiled] [--tile-overlap N]
    [--tile-mode halo|blend] [--batch-tiles N]

The artifact is written by ``Segmenter.export(dir)`` or
``segtpu_torch.infer.save_serving``; the protocol is in
``segtpu_torch/infer/serve.py``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("artifact_dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the artifact runs; cuda raises on a host "
                         "without CUDA")
    ap.add_argument("--tiled", action="store_true",
                    help="serve images of ANY spatial size via "
                         "sliding-window tiling on the artifact "
                         "(whole-slide serving)")
    ap.add_argument("--tile-overlap", type=int, default=32,
                    help="tile context in pixels; with --tile-mode halo, "
                         "overlap 32 = halo 16 per side")
    ap.add_argument("--tile-mode", choices=("halo", "blend"),
                    default="halo",
                    help="halo: exact per-tile composition, highest "
                         "throughput; blend: cosine overlap-add "
                         "probability averaging, smoothest seams")
    ap.add_argument("--batch-tiles", type=int, default=None,
                    help="bound tiles per forward (peak device memory); "
                         "default auto-sizes to one forward per image")
    args = ap.parse_args(argv)

    from segtpu_torch.infer.serve import make_server
    server = make_server(args.artifact_dir, args.host, args.port,
                         tiled=args.tiled, tile_overlap=args.tile_overlap,
                         tile_mode=args.tile_mode,
                         batch_tiles=args.batch_tiles, device=args.device)
    host, port = server.server_address[:2]
    tiled_note = (f", tiled={args.tile_mode}/overlap{args.tile_overlap}"
                  if args.tiled else "")
    print(f"serving {args.artifact_dir} on {args.device} "
          f"(img_size={server.artifact_meta['img_size']}{tiled_note}) "
          f"on http://{host}:{port} — GET /health, POST /predict",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
