"""Distributed training pieces of the port's copy of ``repro.distributed``:
so far the int8 gradient all-reduce with error feedback
(``compression``); sharding and pipelining are not ported (ROADMAP.md
Queue 1 item 14)."""
