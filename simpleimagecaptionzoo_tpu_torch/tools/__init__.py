"""The port's inference tools: ``caption_images`` (a directory of photos)
and ``caption_server`` (HTTP), each run with ``python -m``."""
