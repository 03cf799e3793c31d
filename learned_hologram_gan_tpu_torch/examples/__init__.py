"""Runnable examples of the port's library surface."""
