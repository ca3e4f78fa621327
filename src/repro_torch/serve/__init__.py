"""Serving: the batched-prefill + decode engine with exact or sketched caches."""
