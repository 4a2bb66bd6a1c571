"""Configurations: a JSON file of sizes and a module of its data model each."""
