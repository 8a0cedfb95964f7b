"""Validated application startup (counterpart of the JAX package's
``start_app.py``, reference ``start_app.py:11-61``): environment setup ->
project validation (scaffolding on failure) -> synthetic data if
``data/raw`` is empty -> the port's web server on ``--device`` (default
``cuda``, raising without a card).
"""

from __future__ import annotations

import argparse
import os

from . import setup_project
from .environment import setup_environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--no-serve", action="store_true",
                    help="validate + prepare only (reference start_app "
                         "imports the app module without app.run)")
    ap.add_argument("--seed-data", type=int, default=5,
                    help="synthetic samples to create if data/raw empty")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    from .device import resolve_device
    device = resolve_device(args.device)

    setup_environment()
    if not setup_project.validate():
        print("validation failed — running setup...")
        setup_project.setup()

    raw = "data/raw"
    if args.seed_data and (not os.path.isdir(raw) or not os.listdir(raw)):
        from .data.synthetic import create_synthetic_data
        print(f"seeding {args.seed_data} synthetic volumes into {raw}")
        create_synthetic_data(args.seed_data, raw)

    if args.no_serve:
        print("startup validated; not serving (--no-serve)")
        return 0
    from .serve.app import main as serve_main
    serve_main(args.host, args.port, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
