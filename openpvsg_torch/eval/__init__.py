"""Stage 3's tube matching and stage 5's relation evaluation."""
