"""Kernel build/launch helpers and phase tracing."""
