"""Bytecode, DSL, planner stages, engine, storage and transport of the
port (its copies of ``repro.core``, on PyTorch where data lives)."""
