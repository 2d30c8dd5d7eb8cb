"""The port's tools, each run with ``python -m``: ``caption_images`` (a
directory of photos), ``caption_server`` (HTTP), and
``convert_reference_checkpoint`` / ``export_reference_checkpoint`` (a
reference ``.pth`` to and from the port's checkpoint)."""
