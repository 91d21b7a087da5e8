"""Serving: the paged KV cache and its MAGE page plan (``paged_kv``), and
the prefill/decode steps with the request batcher (``serve_step``)."""
