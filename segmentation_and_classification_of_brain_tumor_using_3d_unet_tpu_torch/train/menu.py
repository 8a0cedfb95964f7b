"""Interactive training menu (counterpart of the JAX package's
``train/menu.py``): pick a preset 1-4 and run the training CLI with its
flags (and any ``extra_args``, e.g. ``["--device", "cpu"]``)."""

from __future__ import annotations

from typing import List, Optional

from .cli import train_main

MENU = """
Select a training configuration:
  1) Fast        — 64^3 volumes, 20 epochs (smoke / debugging)
  2) Standard    — 128^3 volumes, 100 epochs (default quality)
  3) HighQuality — (192,192,128), features up to 1024, 200 epochs
  4) LightWeight — 96^3 volumes, features 16..256
  q) quit
"""

PRESET_ARGS = {
    "1": ["--preset", "fast", "--epochs", "20", "--batch_size", "4",
          "--image_size", "64", "64", "64"],
    "2": ["--preset", "standard", "--epochs", "100"],
    "3": ["--preset", "high_quality", "--epochs", "200",
          "--batch_size", "1"],
    "4": ["--preset", "lightweight", "--epochs", "100"],
}


def main(choice: Optional[str] = None,
         extra_args: Optional[List[str]] = None):
    while True:
        if choice is None:
            print(MENU)
            choice = input("choice> ").strip()
        if choice in ("q", "quit", "exit"):
            return None
        if choice in PRESET_ARGS:
            args = PRESET_ARGS[choice] + list(extra_args or [])
            print(f"launching training with: {' '.join(args)}")
            return train_main(args)
        print(f"invalid choice {choice!r}")
        choice = None


if __name__ == "__main__":
    main()
