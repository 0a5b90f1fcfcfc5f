"""Roofline terms of a step (``analysis``) and the dry-run's tables
(``report``)."""
