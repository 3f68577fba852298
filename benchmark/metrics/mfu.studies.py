"""``mfu.studies``: ``readers.mfu`` in the cells that report
``train_studies_per_s``."""

from readers import mfu as read  # noqa: F401
