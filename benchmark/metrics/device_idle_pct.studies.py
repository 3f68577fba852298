"""``device_idle_pct.studies``: ``readers.device_idle_pct`` in the cells that report
``train_studies_per_s``."""

from readers import device_idle_pct as read  # noqa: F401
