"""Training: static-slot batch layout, the train step, optimizer/LR."""
