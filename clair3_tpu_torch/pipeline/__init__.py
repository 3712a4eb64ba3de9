"""The inference engine and the calling pipeline of the port."""
