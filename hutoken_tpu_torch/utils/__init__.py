"""Host utilities: logging and allocator tuning."""
