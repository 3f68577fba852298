"""``launches_per_step.studies``: ``readers.launches_per_step`` in the cells that report
``train_studies_per_s``."""

from readers import launches_per_step as read  # noqa: F401
