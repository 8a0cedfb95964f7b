"""``python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch``
-> validated startup + the port's web server (reference ``python main.py``;
``--device cpu`` without a card)."""

from .start_app import main

if __name__ == "__main__":
    raise SystemExit(main())
