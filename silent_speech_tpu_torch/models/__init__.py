"""Model families (ported: the official BiGRUClassifier)."""
