"""``mfu.images``: ``readers.mfu`` in the cells that report
``train_images_per_s``."""

from readers import mfu as read  # noqa: F401
