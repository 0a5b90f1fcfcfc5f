"""Launchers: ``serve`` (batched prefill + decode of the dense LM family)."""
