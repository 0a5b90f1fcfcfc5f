"""One driver per kind of cell; ``workloads/<cell>.json`` names the kind."""
