"""The harness: loading cells by name, the measured window, spans and the
profiler trace, and the import guard."""
