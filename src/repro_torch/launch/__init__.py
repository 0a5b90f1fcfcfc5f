"""Launchers: ``serve`` (batched prefill + decode), ``train`` (training,
and its sharded step) and ``mesh`` (DeviceMesh construction)."""
