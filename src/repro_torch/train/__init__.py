"""The single-device training loop (``loop``)."""
