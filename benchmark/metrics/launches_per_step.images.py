"""``launches_per_step.images``: ``readers.launches_per_step`` in the cells that report
``train_images_per_s``."""

from readers import launches_per_step as read  # noqa: F401
