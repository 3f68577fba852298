"""``device_idle_pct.images``: ``readers.device_idle_pct`` in the cells that report
``train_images_per_s``."""

from readers import device_idle_pct as read  # noqa: F401
