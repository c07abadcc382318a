"""Query services."""
