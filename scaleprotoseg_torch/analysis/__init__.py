"""Analysis entry points of the port."""
