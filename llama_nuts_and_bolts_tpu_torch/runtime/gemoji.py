"""Emoji → ``:alias:`` table matching the reference's gemoji-style aliases.

The reference builds its alias map from the Go ``enescakir/emoji`` package
(reference: src/inference/emoji.go:27-40), whose aliases are CLDR short names
lowercased with underscores (e.g. ``:flag_for_turkey:``, ``:man_superhero:``,
``:airplane_arrival:`` — confirmed by the reference's golden transcripts at
cmd/main_test.go:148-323).  This module inlines the same public CLDR-derived
data: single-codepoint emoji (with VS16 where the RGI form carries it), RGI
ZWJ sequences (gendered roles, families, couples), and all regional-indicator
flag sequences.  When one emoji has several aliases the alphabetically first
wins, mirroring the reference's tie-break (src/inference/emoji.go:31-37).

Lookups are *exact string* matches, like the reference's map: 🕰 without VS16
is NOT in the table (gemoji only lists 🕰️) and therefore falls back to
per-rune ``[:MANTELPIECE CLOCK:\\U0001F570]`` annotation.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

# --------------------------------------------------------------------------
# Single emoji (and a few non-ZWJ sequences). Format per line:
#   HEXCP[+HEXCP...] alias
# FE0F components are written explicitly: the table key must match the RGI
# string byte-for-byte, exactly like the Go map.
_SINGLES = """
1F600 grinning_face
1F603 grinning_face_with_big_eyes
1F604 grinning_face_with_smiling_eyes
1F601 beaming_face_with_smiling_eyes
1F606 grinning_squinting_face
1F605 grinning_face_with_sweat
1F923 rolling_on_the_floor_laughing
1F602 face_with_tears_of_joy
1F642 slightly_smiling_face
1F643 upside_down_face
1F609 winking_face
1F60A smiling_face_with_smiling_eyes
1F607 smiling_face_with_halo
1F970 smiling_face_with_hearts
1F60D smiling_face_with_heart_eyes
1F929 star_struck
1F618 face_blowing_a_kiss
1F617 kissing_face
263A+FE0F smiling_face
1F61A kissing_face_with_closed_eyes
1F619 kissing_face_with_smiling_eyes
1F60B face_savoring_food
1F61B face_with_tongue
1F61C winking_face_with_tongue
1F92A zany_face
1F61D squinting_face_with_tongue
1F911 money_mouth_face
1F917 hugging_face
1F92D face_with_hand_over_mouth
1F92B shushing_face
1F914 thinking_face
1F910 zipper_mouth_face
1F928 face_with_raised_eyebrow
1F610 neutral_face
1F611 expressionless_face
1F636 face_without_mouth
1F60F smirking_face
1F612 unamused_face
1F644 face_with_rolling_eyes
1F62C grimacing_face
1F925 lying_face
1F60C relieved_face
1F614 pensive_face
1F62A sleepy_face
1F924 drooling_face
1F634 sleeping_face
1F637 face_with_medical_mask
1F912 face_with_thermometer
1F915 face_with_head_bandage
1F922 nauseated_face
1F92E face_vomiting
1F927 sneezing_face
1F975 hot_face
1F976 cold_face
1F974 woozy_face
1F635 dizzy_face
1F92F exploding_head
1F920 cowboy_hat_face
1F973 partying_face
1F60E smiling_face_with_sunglasses
1F913 nerd_face
1F9D0 face_with_monocle
1F615 confused_face
1F61F worried_face
1F641 slightly_frowning_face
2639+FE0F frowning_face
1F62E face_with_open_mouth
1F62F hushed_face
1F632 astonished_face
1F633 flushed_face
1F97A pleading_face
1F626 frowning_face_with_open_mouth
1F627 anguished_face
1F628 fearful_face
1F630 anxious_face_with_sweat
1F625 sad_but_relieved_face
1F622 crying_face
1F62D loudly_crying_face
1F631 face_screaming_in_fear
1F616 confounded_face
1F623 persevering_face
1F61E disappointed_face
1F613 downcast_face_with_sweat
1F629 weary_face
1F62B tired_face
1F624 face_with_steam_from_nose
1F621 pouting_face
1F620 angry_face
1F92C face_with_symbols_on_mouth
1F608 smiling_face_with_horns
1F47F angry_face_with_horns
1F480 skull
2620+FE0F skull_and_crossbones
1F4A9 pile_of_poo
1F921 clown_face
1F479 ogre
1F47A goblin
1F47B ghost
1F47D alien
1F47E alien_monster
1F916 robot
1F63A grinning_cat
1F638 grinning_cat_with_smiling_eyes
1F639 cat_with_tears_of_joy
1F63B smiling_cat_with_heart_eyes
1F63C cat_with_wry_smile
1F63D kissing_cat
1F640 weary_cat
1F63F crying_cat
1F63E pouting_cat
1F648 see_no_evil_monkey
1F649 hear_no_evil_monkey
1F64A speak_no_evil_monkey
1F48B kiss_mark
1F48C love_letter
1F498 heart_with_arrow
1F49D heart_with_ribbon
1F496 sparkling_heart
1F497 growing_heart
1F493 beating_heart
1F49E revolving_hearts
1F495 two_hearts
1F49F heart_decoration
2763+FE0F heart_exclamation
1F494 broken_heart
2764+FE0F red_heart
1F9E1 orange_heart
1F49B yellow_heart
1F49A green_heart
1F499 blue_heart
1F49C purple_heart
1F90E brown_heart
1F5A4 black_heart
1F90D white_heart
1F4AF hundred_points
1F4A2 anger_symbol
1F4A5 collision
1F4AB dizzy
1F4A6 sweat_droplets
1F4A8 dashing_away
1F573+FE0F hole
1F4A3 bomb
1F4AC speech_balloon
1F5E8+FE0F left_speech_bubble
1F5EF+FE0F right_anger_bubble
1F4AD thought_balloon
1F4A4 zzz
1F44B waving_hand
1F91A raised_back_of_hand
1F590+FE0F hand_with_fingers_splayed
270B raised_hand
1F596 vulcan_salute
1F44C ok_hand
1F90F pinching_hand
270C+FE0F victory_hand
1F91E crossed_fingers
1F91F love_you_gesture
1F918 sign_of_the_horns
1F919 call_me_hand
1F448 backhand_index_pointing_left
1F449 backhand_index_pointing_right
1F446 backhand_index_pointing_up
1F595 middle_finger
1F447 backhand_index_pointing_down
261D+FE0F index_pointing_up
1F44D thumbs_up
1F44E thumbs_down
270A raised_fist
1F44A oncoming_fist
1F91B left_facing_fist
1F91C right_facing_fist
1F44F clapping_hands
1F64C raising_hands
1F450 open_hands
1F932 palms_up_together
1F91D handshake
1F64F folded_hands
270D+FE0F writing_hand
1F485 nail_polish
1F933 selfie
1F4AA flexed_biceps
1F9BE mechanical_arm
1F9BF mechanical_leg
1F9B5 leg
1F9B6 foot
1F442 ear
1F9BB ear_with_hearing_aid
1F443 nose
1F9E0 brain
1F9B7 tooth
1F9B4 bone
1F440 eyes
1F441+FE0F eye
1F445 tongue
1F444 mouth
1F476 baby
1F9D2 child
1F466 boy
1F467 girl
1F9D1 person
1F468 man
1F469 woman
1F9D3 older_person
1F474 old_man
1F475 old_woman
1F64D person_frowning
1F64E person_pouting
1F645 person_gesturing_no
1F646 person_gesturing_ok
1F481 person_tipping_hand
1F64B person_raising_hand
1F9CF deaf_person
1F647 person_bowing
1F926 person_facepalming
1F937 person_shrugging
1F46E police_officer
1F575+FE0F detective
1F482 guard
1F477 construction_worker
1F934 prince
1F478 princess
1F473 person_wearing_turban
1F9D5 woman_with_headscarf
1F935 man_in_tuxedo
1F470 bride_with_veil
1F930 pregnant_woman
1F931 breast_feeding
1F47C baby_angel
1F385 santa_claus
1F936 mrs_claus
1F9B8 superhero
1F9B9 supervillain
1F9D9 mage
1F9DA fairy
1F9DB vampire
1F9DC merperson
1F9DD elf
1F9DE genie
1F9DF zombie
1F486 person_getting_massage
1F487 person_getting_haircut
1F6B6 person_walking
1F9CD person_standing
1F9CE person_kneeling
1F3C3 person_running
1F483 woman_dancing
1F57A man_dancing
1F574+FE0F person_in_suit_levitating
1F46F people_with_bunny_ears
1F9D6 person_in_steamy_room
1F9D7 person_climbing
1F93A person_fencing
1F3C7 horse_racing
26F7+FE0F skier
1F3C2 snowboarder
1F3CC+FE0F person_golfing
1F3C4 person_surfing
1F6A3 person_rowing_boat
1F3CA person_swimming
26F9+FE0F person_bouncing_ball
1F3CB+FE0F person_lifting_weights
1F6B4 person_biking
1F6B5 person_mountain_biking
1F938 person_cartwheeling
1F93C people_wrestling
1F93D person_playing_water_polo
1F93E person_playing_handball
1F939 person_juggling
1F9D8 person_in_lotus_position
1F6C0 person_taking_bath
1F6CC person_in_bed
1F46D women_holding_hands
1F46B woman_and_man_holding_hands
1F46C men_holding_hands
1F48F kiss
1F491 couple_with_heart
1F46A family
1F5E3+FE0F speaking_head
1F464 bust_in_silhouette
1F465 busts_in_silhouette
1F463 footprints
1F9B0 red_hair
1F9B1 curly_hair
1F9B3 white_hair
1F9B2 bald
1F435 monkey_face
1F412 monkey
1F98D gorilla
1F9A7 orangutan
1F436 dog_face
1F415 dog
1F9AE guide_dog
1F429 poodle
1F43A wolf
1F98A fox
1F99D raccoon
1F431 cat_face
1F408 cat
1F981 lion
1F42F tiger_face
1F405 tiger
1F406 leopard
1F434 horse_face
1F40E horse
1F984 unicorn
1F993 zebra
1F98C deer
1F42E cow_face
1F402 ox
1F403 water_buffalo
1F404 cow
1F437 pig_face
1F416 pig
1F417 boar
1F43D pig_nose
1F40F ram
1F411 ewe
1F410 goat
1F42A camel
1F42B two_hump_camel
1F999 llama
1F992 giraffe
1F418 elephant
1F98F rhinoceros
1F99B hippopotamus
1F42D mouse_face
1F401 mouse
1F400 rat
1F439 hamster
1F430 rabbit_face
1F407 rabbit
1F43F+FE0F chipmunk
1F994 hedgehog
1F987 bat
1F43B bear
1F428 koala
1F43C panda
1F9A5 sloth
1F9A6 otter
1F9A8 skunk
1F998 kangaroo
1F9A1 badger
1F43E paw_prints
1F983 turkey
1F414 chicken
1F413 rooster
1F423 hatching_chick
1F424 baby_chick
1F425 front_facing_baby_chick
1F426 bird
1F427 penguin
1F54A+FE0F dove
1F985 eagle
1F986 duck
1F9A2 swan
1F989 owl
1F9A9 flamingo
1F99A peacock
1F99C parrot
1F438 frog
1F40A crocodile
1F422 turtle
1F98E lizard
1F40D snake
1F432 dragon_face
1F409 dragon
1F995 sauropod
1F996 t_rex
1F433 spouting_whale
1F40B whale
1F42C dolphin
1F41F fish
1F420 tropical_fish
1F421 blowfish
1F988 shark
1F419 octopus
1F41A spiral_shell
1F40C snail
1F98B butterfly
1F41B bug
1F41C ant
1F41D honeybee
1F41E lady_beetle
1F997 cricket
1F577+FE0F spider
1F578+FE0F spider_web
1F982 scorpion
1F99F mosquito
1F9A0 microbe
1F490 bouquet
1F338 cherry_blossom
1F4AE white_flower
1F3F5+FE0F rosette
1F339 rose
1F940 wilted_flower
1F33A hibiscus
1F33B sunflower
1F33C blossom
1F337 tulip
1F331 seedling
1F332 evergreen_tree
1F333 deciduous_tree
1F334 palm_tree
1F335 cactus
1F33E sheaf_of_rice
1F33F herb
2618+FE0F shamrock
1F340 four_leaf_clover
1F341 maple_leaf
1F342 fallen_leaf
1F343 leaf_fluttering_in_wind
1F347 grapes
1F348 melon
1F349 watermelon
1F34A tangerine
1F34B lemon
1F34C banana
1F34D pineapple
1F96D mango
1F34E red_apple
1F34F green_apple
1F350 pear
1F351 peach
1F352 cherries
1F353 strawberry
1F95D kiwi_fruit
1F345 tomato
1F965 coconut
1F951 avocado
1F346 eggplant
1F954 potato
1F955 carrot
1F33D ear_of_corn
1F336+FE0F hot_pepper
1F952 cucumber
1F96C leafy_green
1F966 broccoli
1F9C4 garlic
1F9C5 onion
1F344 mushroom
1F95C peanuts
1F330 chestnut
1F35E bread
1F950 croissant
1F956 baguette_bread
1F968 pretzel
1F96F bagel
1F95E pancakes
1F9C7 waffle
1F9C0 cheese_wedge
1F356 meat_on_bone
1F357 poultry_leg
1F969 cut_of_meat
1F953 bacon
1F354 hamburger
1F35F french_fries
1F355 pizza
1F32D hot_dog
1F96A sandwich
1F32E taco
1F32F burrito
1F959 stuffed_flatbread
1F9C6 falafel
1F95A egg
1F373 cooking
1F958 shallow_pan_of_food
1F372 pot_of_food
1F963 bowl_with_spoon
1F957 green_salad
1F37F popcorn
1F9C8 butter
1F9C2 salt
1F96B canned_food
1F371 bento_box
1F358 rice_cracker
1F359 rice_ball
1F35A cooked_rice
1F35B curry_rice
1F35C steaming_bowl
1F35D spaghetti
1F360 roasted_sweet_potato
1F362 oden
1F363 sushi
1F364 fried_shrimp
1F365 fish_cake_with_swirl
1F96E moon_cake
1F361 dango
1F95F dumpling
1F960 fortune_cookie
1F961 takeout_box
1F980 crab
1F99E lobster
1F990 shrimp
1F991 squid
1F9AA oyster
1F366 soft_ice_cream
1F367 shaved_ice
1F368 ice_cream
1F369 doughnut
1F36A cookie
1F382 birthday_cake
1F370 shortcake
1F9C1 cupcake
1F967 pie
1F36B chocolate_bar
1F36C candy
1F36D lollipop
1F36E custard
1F36F honey_pot
1F37C baby_bottle
1F95B glass_of_milk
2615 hot_beverage
1F375 teacup_without_handle
1F376 sake
1F37E bottle_with_popping_cork
1F377 wine_glass
1F378 cocktail_glass
1F379 tropical_drink
1F37A beer_mug
1F37B clinking_beer_mugs
1F942 clinking_glasses
1F943 tumbler_glass
1F964 cup_with_straw
1F9C3 beverage_box
1F9C9 mate
1F962 chopsticks
1F37D+FE0F fork_and_knife_with_plate
1F374 fork_and_knife
1F944 spoon
1F52A kitchen_knife
1F3FA amphora
1F30D globe_showing_europe_africa
1F30E globe_showing_americas
1F30F globe_showing_asia_australia
1F310 globe_with_meridians
1F5FA+FE0F world_map
1F5FE map_of_japan
1F9ED compass
1F3D4+FE0F snow_capped_mountain
26F0+FE0F mountain
1F30B volcano
1F5FB mount_fuji
1F3D5+FE0F camping
1F3D6+FE0F beach_with_umbrella
1F3DC+FE0F desert
1F3DD+FE0F desert_island
1F3DE+FE0F national_park
1F3DF+FE0F stadium
1F3DB+FE0F classical_building
1F3D7+FE0F building_construction
1F9F1 brick
1F3D8+FE0F houses
1F3DA+FE0F derelict_house
1F3E0 house
1F3E1 house_with_garden
1F3E2 office_building
1F3E3 japanese_post_office
1F3E4 post_office
1F3E5 hospital
1F3E6 bank
1F3E8 hotel
1F3E9 love_hotel
1F3EA convenience_store
1F3EB school
1F3EC department_store
1F3ED factory
1F3EF japanese_castle
1F3F0 castle
1F492 wedding
1F5FC tokyo_tower
1F5FD statue_of_liberty
26EA church
1F54C mosque
1F6D5 hindu_temple
1F54D synagogue
26E9+FE0F shinto_shrine
1F54B kaaba
26F2 fountain
26FA tent
1F301 foggy
1F303 night_with_stars
1F3D9+FE0F cityscape
1F304 sunrise_over_mountains
1F305 sunrise
1F306 cityscape_at_dusk
1F307 sunset
1F309 bridge_at_night
2668+FE0F hot_springs
1F3A0 carousel_horse
1F3A1 ferris_wheel
1F3A2 roller_coaster
1F488 barber_pole
1F3AA circus_tent
1F682 locomotive
1F683 railway_car
1F684 high_speed_train
1F685 bullet_train
1F686 train
1F687 metro
1F688 light_rail
1F689 station
1F68A tram
1F69D monorail
1F69E mountain_railway
1F68B tram_car
1F68C bus
1F68D oncoming_bus
1F68E trolleybus
1F690 minibus
1F691 ambulance
1F692 fire_engine
1F693 police_car
1F694 oncoming_police_car
1F695 taxi
1F696 oncoming_taxi
1F697 automobile
1F698 oncoming_automobile
1F699 sport_utility_vehicle
1F69A delivery_truck
1F69B articulated_lorry
1F69C tractor
1F3CE+FE0F racing_car
1F3CD+FE0F motorcycle
1F6F5 motor_scooter
1F9BD manual_wheelchair
1F9BC motorized_wheelchair
1F6FA auto_rickshaw
1F6B2 bicycle
1F6F4 kick_scooter
1F6F9 skateboard
1F68F bus_stop
1F6E3+FE0F motorway
1F6E4+FE0F railway_track
1F6E2+FE0F oil_drum
26FD fuel_pump
1F6A8 police_car_light
1F6A5 horizontal_traffic_light
1F6A6 vertical_traffic_light
1F6D1 stop_sign
1F6A7 construction
2693 anchor
26F5 sailboat
1F6F6 canoe
1F6A4 speedboat
1F6F3+FE0F passenger_ship
26F4+FE0F ferry
1F6E5+FE0F motor_boat
1F6A2 ship
2708+FE0F airplane
1F6E9+FE0F small_airplane
1F6EB airplane_departure
1F6EC airplane_arrival
1FA82 parachute
1F4BA seat
1F681 helicopter
1F69F suspension_railway
1F6A0 mountain_cableway
1F6A1 aerial_tramway
1F6F0+FE0F satellite
1F680 rocket
1F6F8 flying_saucer
1F6CE+FE0F bellhop_bell
1F9F3 luggage
231B hourglass_done
23F3 hourglass_not_done
231A watch
23F0 alarm_clock
23F1+FE0F stopwatch
23F2+FE0F timer_clock
1F570+FE0F mantelpiece_clock
1F311 new_moon
1F312 waxing_crescent_moon
1F313 first_quarter_moon
1F314 waxing_gibbous_moon
1F315 full_moon
1F316 waning_gibbous_moon
1F317 last_quarter_moon
1F318 waning_crescent_moon
1F319 crescent_moon
1F31A new_moon_face
1F31B first_quarter_moon_face
1F31C last_quarter_moon_face
1F321+FE0F thermometer
2600+FE0F sun
1F31D full_moon_face
1F31E sun_with_face
1FA90 ringed_planet
2B50 star
1F31F glowing_star
1F320 shooting_star
1F30C milky_way
2601+FE0F cloud
26C5 sun_behind_cloud
26C8+FE0F cloud_with_lightning_and_rain
1F324+FE0F sun_behind_small_cloud
1F325+FE0F sun_behind_large_cloud
1F326+FE0F sun_behind_rain_cloud
1F327+FE0F cloud_with_rain
1F328+FE0F cloud_with_snow
1F329+FE0F cloud_with_lightning
1F32A+FE0F tornado
1F32B+FE0F fog
1F32C+FE0F wind_face
1F300 cyclone
1F308 rainbow
1F302 closed_umbrella
2602+FE0F umbrella
2614 umbrella_with_rain_drops
26F1+FE0F umbrella_on_ground
26A1 high_voltage
2744+FE0F snowflake
2603+FE0F snowman
26C4 snowman_without_snow
2604+FE0F comet
1F525 fire
1F4A7 droplet
1F30A water_wave
1F383 jack_o_lantern
1F384 christmas_tree
1F386 fireworks
1F387 sparkler
1F9E8 firecracker
2728 sparkles
1F388 balloon
1F389 party_popper
1F38A confetti_ball
1F38B tanabata_tree
1F38D pine_decoration
1F38E japanese_dolls
1F38F carp_streamer
1F390 wind_chime
1F391 moon_viewing_ceremony
1F9E7 red_envelope
1F380 ribbon
1F381 wrapped_gift
1F397+FE0F reminder_ribbon
1F39F+FE0F admission_tickets
1F3AB ticket
1F396+FE0F military_medal
1F3C6 trophy
1F3C5 sports_medal
1F947 1st_place_medal
1F948 2nd_place_medal
1F949 3rd_place_medal
26BD soccer_ball
26BE baseball
1F94E softball
1F3C0 basketball
1F3D0 volleyball
1F3C8 american_football
1F3C9 rugby_football
1F3BE tennis
1F94F flying_disc
1F3B3 bowling
1F3CF cricket_game
1F3D1 field_hockey
1F3D2 ice_hockey
1F94D lacrosse
1F3D3 ping_pong
1F3F8 badminton
1F94A boxing_glove
1F94B martial_arts_uniform
1F945 goal_net
26F3 flag_in_hole
26F8+FE0F ice_skate
1F3A3 fishing_pole
1F93F diving_mask
1F3BD running_shirt
1F3BF skis
1F6F7 sled
1F94C curling_stone
1F3AF direct_hit
1FA80 yo_yo
1FA81 kite
1F3B1 pool_8_ball
1F52E crystal_ball
1F9FF nazar_amulet
1F3AE video_game
1F579+FE0F joystick
1F3B0 slot_machine
1F3B2 game_die
1F9E9 puzzle_piece
1F9F8 teddy_bear
2660+FE0F spade_suit
2665+FE0F heart_suit
2666+FE0F diamond_suit
2663+FE0F club_suit
265F+FE0F chess_pawn
1F0CF joker
1F004 mahjong_red_dragon
1F3B4 flower_playing_cards
1F3AD performing_arts
1F5BC+FE0F framed_picture
1F3A8 artist_palette
1F9F5 thread
1F9F6 yarn
1F453 glasses
1F576+FE0F sunglasses
1F97D goggles
1F97C lab_coat
1F9BA safety_vest
1F454 necktie
1F455 t_shirt
1F456 jeans
1F9E3 scarf
1F9E4 gloves
1F9E5 coat
1F9E6 socks
1F457 dress
1F458 kimono
1F97B sari
1FA71 one_piece_swimsuit
1F459 bikini
1F45A womans_clothes
1F45B purse
1F45C handbag
1F45D clutch_bag
1F6CD+FE0F shopping_bags
1F392 backpack
1F45E mans_shoe
1F45F running_shoe
1F97E hiking_boot
1F97F flat_shoe
1F460 high_heeled_shoe
1F461 womans_sandal
1FA70 ballet_shoes
1F462 womans_boot
1F451 crown
1F452 womans_hat
1F3A9 top_hat
1F393 graduation_cap
1F9E2 billed_cap
26D1+FE0F rescue_workers_helmet
1F4FF prayer_beads
1F484 lipstick
1F48D ring
1F48E gem_stone
1F507 muted_speaker
1F508 speaker_low_volume
1F509 speaker_medium_volume
1F50A speaker_high_volume
1F4E2 loudspeaker
1F4E3 megaphone
1F4EF postal_horn
1F514 bell
1F515 bell_with_slash
1F3BC musical_score
1F3B5 musical_note
1F3B6 musical_notes
1F399+FE0F studio_microphone
1F39A+FE0F level_slider
1F39B+FE0F control_knobs
1F3A4 microphone
1F3A7 headphone
1F4FB radio
1F3B7 saxophone
1F3B8 guitar
1F3B9 musical_keyboard
1F3BA trumpet
1F3BB violin
1FA95 banjo
1F941 drum
1F4F1 mobile_phone
1F4F2 mobile_phone_with_arrow
260E+FE0F telephone
1F4DE telephone_receiver
1F4DF pager
1F4E0 fax_machine
1F50B battery
1F50C electric_plug
1F4BB laptop
1F5A5+FE0F desktop_computer
1F5A8+FE0F printer
2328+FE0F keyboard
1F5B1+FE0F computer_mouse
1F5B2+FE0F trackball
1F4BD computer_disk
1F4BE floppy_disk
1F4BF optical_disk
1F4C0 dvd
1F9EE abacus
1F3A5 movie_camera
1F39E+FE0F film_frames
1F4FD+FE0F film_projector
1F3AC clapper_board
1F4FA television
1F4F7 camera
1F4F8 camera_with_flash
1F4F9 video_camera
1F4FC videocassette
1F50D magnifying_glass_tilted_left
1F50E magnifying_glass_tilted_right
1F56F+FE0F candle
1F4A1 light_bulb
1F526 flashlight
1F3EE red_paper_lantern
1FA94 diya_lamp
1F4D4 notebook_with_decorative_cover
1F4D5 closed_book
1F4D6 open_book
1F4D7 green_book
1F4D8 blue_book
1F4D9 orange_book
1F4DA books
1F4D3 notebook
1F4D2 ledger
1F4C3 page_with_curl
1F4DC scroll
1F4C4 page_facing_up
1F4F0 newspaper
1F5DE+FE0F rolled_up_newspaper
1F4D1 bookmark_tabs
1F516 bookmark
1F3F7+FE0F label
1F4B0 money_bag
1F4B4 yen_banknote
1F4B5 dollar_banknote
1F4B6 euro_banknote
1F4B7 pound_banknote
1F4B8 money_with_wings
1F4B3 credit_card
1F9FE receipt
1F4B9 chart_increasing_with_yen
2709+FE0F envelope
1F4E7 e_mail
1F4E8 incoming_envelope
1F4E9 envelope_with_arrow
1F4E4 outbox_tray
1F4E5 inbox_tray
1F4E6 package
1F4EB closed_mailbox_with_raised_flag
1F4EA closed_mailbox_with_lowered_flag
1F4EC open_mailbox_with_raised_flag
1F4ED open_mailbox_with_lowered_flag
1F4EE postbox
1F5F3+FE0F ballot_box_with_ballot
270F+FE0F pencil
2712+FE0F black_nib
1F58B+FE0F fountain_pen
1F58A+FE0F pen
1F58C+FE0F paintbrush
1F58D+FE0F crayon
1F4DD memo
1F4BC briefcase
1F4C1 file_folder
1F4C2 open_file_folder
1F5C2+FE0F card_index_dividers
1F4C5 calendar
1F4C6 tear_off_calendar
1F5D2+FE0F spiral_notepad
1F5D3+FE0F spiral_calendar
1F4C7 card_index
1F4C8 chart_increasing
1F4C9 chart_decreasing
1F4CA bar_chart
1F4CB clipboard
1F4CC pushpin
1F4CD round_pushpin
1F4CE paperclip
1F587+FE0F linked_paperclips
1F4CF straight_ruler
1F4D0 triangular_ruler
2702+FE0F scissors
1F5C3+FE0F card_file_box
1F5C4+FE0F file_cabinet
1F5D1+FE0F wastebasket
1F512 locked
1F513 unlocked
1F50F locked_with_pen
1F510 locked_with_key
1F511 key
1F5DD+FE0F old_key
1F528 hammer
1FA93 axe
26CF+FE0F pick
2692+FE0F hammer_and_pick
1F6E0+FE0F hammer_and_wrench
1F5E1+FE0F dagger
2694+FE0F crossed_swords
1F52B pistol
1F3F9 bow_and_arrow
1F6E1+FE0F shield
1F527 wrench
1F529 nut_and_bolt
2699+FE0F gear
1F5DC+FE0F clamp
2696+FE0F balance_scale
1F9AF probing_cane
1F517 link
26D3+FE0F chains
1F9F0 toolbox
1F9F2 magnet
2697+FE0F alembic
1F9EA test_tube
1F9EB petri_dish
1F9EC dna
1F52C microscope
1F52D telescope
1F4E1 satellite_antenna
1F489 syringe
1FA78 drop_of_blood
1F48A pill
1FA79 adhesive_bandage
1FA7A stethoscope
1F6AA door
1F6CF+FE0F bed
1F6CB+FE0F couch_and_lamp
1FA91 chair
1F6BD toilet
1F6BF shower
1F6C1 bathtub
1FA92 razor
1F9F4 lotion_bottle
1F9F7 safety_pin
1F9F9 broom
1F9FA basket
1F9FB roll_of_paper
1F9FC soap
1F9FD sponge
1F9EF fire_extinguisher
1F6D2 shopping_cart
1F6AC cigarette
26B0+FE0F coffin
26B1+FE0F funeral_urn
1F5FF moai
1F3E7 atm_sign
1F6AE litter_in_bin_sign
1F6B0 potable_water
267F wheelchair_symbol
1F6B9 mens_room
1F6BA womens_room
1F6BB restroom
1F6BC baby_symbol
1F6BE water_closet
1F6C2 passport_control
1F6C3 customs
1F6C4 baggage_claim
1F6C5 left_luggage
26A0+FE0F warning
1F6B8 children_crossing
26D4 no_entry
1F6AB prohibited
1F6B3 no_bicycles
1F6AD no_smoking
1F6AF no_littering
1F6B1 non_potable_water
1F6B7 no_pedestrians
1F4F5 no_mobile_phones
1F51E no_one_under_eighteen
2622+FE0F radioactive
2623+FE0F biohazard
2B06+FE0F up_arrow
2197+FE0F up_right_arrow
27A1+FE0F right_arrow
2198+FE0F down_right_arrow
2B07+FE0F down_arrow
2199+FE0F down_left_arrow
2B05+FE0F left_arrow
2196+FE0F up_left_arrow
2195+FE0F up_down_arrow
2194+FE0F left_right_arrow
21A9+FE0F right_arrow_curving_left
21AA+FE0F left_arrow_curving_right
2934+FE0F right_arrow_curving_up
2935+FE0F right_arrow_curving_down
1F503 clockwise_vertical_arrows
1F504 counterclockwise_arrows_button
1F519 back_arrow
1F51A end_arrow
1F51B on_arrow
1F51C soon_arrow
1F51D top_arrow
1F6D0 place_of_worship
269B+FE0F atom_symbol
1F549+FE0F om
2721+FE0F star_of_david
2638+FE0F wheel_of_dharma
262F+FE0F yin_yang
271D+FE0F latin_cross
2626+FE0F orthodox_cross
262A+FE0F star_and_crescent
262E+FE0F peace_symbol
1F54E menorah
1F52F dotted_six_pointed_star
2648 aries
2649 taurus
264A gemini
264B cancer
264C leo
264D virgo
264E libra
264F scorpio
2650 sagittarius
2651 capricorn
2652 aquarius
2653 pisces
26CE ophiuchus
1F500 shuffle_tracks_button
1F501 repeat_button
1F502 repeat_single_button
25B6+FE0F play_button
23E9 fast_forward_button
23ED+FE0F next_track_button
23EF+FE0F play_or_pause_button
25C0+FE0F reverse_button
23EA fast_reverse_button
23EE+FE0F last_track_button
1F53C upwards_button
23EB fast_up_button
1F53D downwards_button
23EC fast_down_button
23F8+FE0F pause_button
23F9+FE0F stop_button
23FA+FE0F record_button
23CF+FE0F eject_button
1F3A6 cinema
1F505 dim_button
1F506 bright_button
1F4F6 antenna_bars
1F4F3 vibration_mode
1F4F4 mobile_phone_off
2640+FE0F female_sign
2642+FE0F male_sign
2695+FE0F medical_symbol
267E+FE0F infinity
267B+FE0F recycling_symbol
269C+FE0F fleur_de_lis
1F531 trident_emblem
1F4DB name_badge
1F530 japanese_symbol_for_beginner
2B55 hollow_red_circle
2705 check_mark_button
2611+FE0F check_box_with_check
2714+FE0F check_mark
274C cross_mark
274E cross_mark_button
27B0 curly_loop
27BF double_curly_loop
303D+FE0F part_alternation_mark
2733+FE0F eight_spoked_asterisk
2734+FE0F eight_pointed_star
2747+FE0F sparkle
203C+FE0F double_exclamation_mark
2049+FE0F exclamation_question_mark
2753 question_mark
2754 white_question_mark
2755 white_exclamation_mark
2757 exclamation_mark
3030+FE0F wavy_dash
A9+FE0F copyright
AE+FE0F registered
2122+FE0F trade_mark
1F51F keycap_10
1F520 input_latin_uppercase
1F521 input_latin_lowercase
1F522 input_numbers
1F523 input_symbols
1F524 input_latin_letters
1F198 sos_button
1F195 new_button
1F193 free_button
1F196 ng_button
1F197 ok_button
1F199 up_button
1F192 cool_button
1F191 cl_button
1F194 id_button
1F534 red_circle
1F7E0 orange_circle
1F7E1 yellow_circle
1F7E2 green_circle
1F535 blue_circle
1F7E3 purple_circle
1F7E4 brown_circle
26AB black_circle
26AA white_circle
1F7E5 red_square
1F7E7 orange_square
1F7E8 yellow_square
1F7E9 green_square
1F7E6 blue_square
1F7EA purple_square
1F7EB brown_square
2B1B black_large_square
2B1C white_large_square
25FC+FE0F black_medium_square
25FB+FE0F white_medium_square
25FE black_medium_small_square
25FD white_medium_small_square
25AA+FE0F black_small_square
25AB+FE0F white_small_square
1F536 large_orange_diamond
1F537 large_blue_diamond
1F538 small_orange_diamond
1F539 small_blue_diamond
1F53A red_triangle_pointed_up
1F53B red_triangle_pointed_down
1F4A0 diamond_with_a_dot
1F518 radio_button
1F533 white_square_button
1F532 black_square_button
1F3C1 chequered_flag
1F6A9 triangular_flag
1F38C crossed_flags
1F3F4 black_flag
1F3F3+FE0F white_flag
"""

# ZWJ sequence groups generated below ------------------------------------

# person-activity bases that form "man_X"/"woman_X" with ZWJ + gender sign.
# entries: (base codepoints, man alias, woman alias)
_GENDERED = [
    ("1F64D", "man_frowning", "woman_frowning"),
    ("1F64E", "man_pouting", "woman_pouting"),
    ("1F645", "man_gesturing_no", "woman_gesturing_no"),
    ("1F646", "man_gesturing_ok", "woman_gesturing_ok"),
    ("1F481", "man_tipping_hand", "woman_tipping_hand"),
    ("1F64B", "man_raising_hand", "woman_raising_hand"),
    ("1F9CF", "deaf_man", "deaf_woman"),
    ("1F647", "man_bowing", "woman_bowing"),
    ("1F926", "man_facepalming", "woman_facepalming"),
    ("1F937", "man_shrugging", "woman_shrugging"),
    ("1F46E", "man_police_officer", "woman_police_officer"),
    ("1F575+FE0F", "man_detective", "woman_detective"),
    ("1F482", "man_guard", "woman_guard"),
    ("1F477", "man_construction_worker", "woman_construction_worker"),
    ("1F473", "man_wearing_turban", "woman_wearing_turban"),
    ("1F9B8", "man_superhero", "woman_superhero"),
    ("1F9B9", "man_supervillain", "woman_supervillain"),
    ("1F9D9", "man_mage", "woman_mage"),
    ("1F9DA", "man_fairy", "woman_fairy"),
    ("1F9DB", "man_vampire", "woman_vampire"),
    ("1F9DC", "merman", "mermaid"),
    ("1F9DD", "man_elf", "woman_elf"),
    ("1F9DE", "man_genie", "woman_genie"),
    ("1F9DF", "man_zombie", "woman_zombie"),
    ("1F486", "man_getting_massage", "woman_getting_massage"),
    ("1F487", "man_getting_haircut", "woman_getting_haircut"),
    ("1F6B6", "man_walking", "woman_walking"),
    ("1F9CD", "man_standing", "woman_standing"),
    ("1F9CE", "man_kneeling", "woman_kneeling"),
    ("1F3C3", "man_running", "woman_running"),
    ("1F46F", "men_with_bunny_ears", "women_with_bunny_ears"),
    ("1F9D6", "man_in_steamy_room", "woman_in_steamy_room"),
    ("1F9D7", "man_climbing", "woman_climbing"),
    ("1F3CC+FE0F", "man_golfing", "woman_golfing"),
    ("1F3C4", "man_surfing", "woman_surfing"),
    ("1F6A3", "man_rowing_boat", "woman_rowing_boat"),
    ("1F3CA", "man_swimming", "woman_swimming"),
    ("26F9+FE0F", "man_bouncing_ball", "woman_bouncing_ball"),
    ("1F3CB+FE0F", "man_lifting_weights", "woman_lifting_weights"),
    ("1F6B4", "man_biking", "woman_biking"),
    ("1F6B5", "man_mountain_biking", "woman_mountain_biking"),
    ("1F938", "man_cartwheeling", "woman_cartwheeling"),
    ("1F93C", "men_wrestling", "women_wrestling"),
    ("1F93D", "man_playing_water_polo", "woman_playing_water_polo"),
    ("1F93E", "man_playing_handball", "woman_playing_handball"),
    ("1F939", "man_juggling", "woman_juggling"),
    ("1F9D8", "man_in_lotus_position", "woman_in_lotus_position"),
]

# 1F468/1F469 + ZWJ + object → profession. entries: (object cps, role)
_PROFESSIONS = [
    ("2695+FE0F", "health_worker"),
    ("1F393", "student"),
    ("1F3EB", "teacher"),
    ("2696+FE0F", "judge"),
    ("1F33E", "farmer"),
    ("1F373", "cook"),
    ("1F527", "mechanic"),
    ("1F3ED", "factory_worker"),
    ("1F4BC", "office_worker"),
    ("1F52C", "scientist"),
    ("1F4BB", "technologist"),
    ("1F3A4", "singer"),
    ("1F3A8", "artist"),
    ("2708+FE0F", "pilot"),
    ("1F680", "astronaut"),
    ("1F692", "firefighter"),
]

# 1F468/1F469 + ZWJ + hair component
_HAIR = [("1F9B0", "red_hair"), ("1F9B1", "curly_hair"),
         ("1F9B3", "white_hair"), ("1F9B2", "bald")]

# RGI family child combos (suffix alias part, child cps)
_CHILD_COMBOS = [
    ("boy", ["1F466"]),
    ("girl", ["1F467"]),
    ("girl_boy", ["1F467", "1F466"]),
    ("boy_boy", ["1F466", "1F466"]),
    ("girl_girl", ["1F467", "1F467"]),
]
_PARENT_COMBOS = [
    ("man_woman", ["1F468", "1F469"]),
    ("man_man", ["1F468", "1F468"]),
    ("woman_woman", ["1F469", "1F469"]),
    ("man", ["1F468"]),
    ("woman", ["1F469"]),
]

# Other RGI ZWJ sequences
_OTHER_ZWJ = [
    ("1F468+200D+2764+FE0F+200D+1F468", "couple_with_heart_man_man"),
    ("1F469+200D+2764+FE0F+200D+1F468", "couple_with_heart_woman_man"),
    ("1F469+200D+2764+FE0F+200D+1F469", "couple_with_heart_woman_woman"),
    ("1F468+200D+2764+FE0F+200D+1F48B+200D+1F468", "kiss_man_man"),
    ("1F469+200D+2764+FE0F+200D+1F48B+200D+1F468", "kiss_woman_man"),
    ("1F469+200D+2764+FE0F+200D+1F48B+200D+1F469", "kiss_woman_woman"),
    ("1F3F3+FE0F+200D+1F308", "rainbow_flag"),
    ("1F3F4+200D+2620+FE0F", "pirate_flag"),
    ("1F415+200D+1F9BA", "service_dog"),
    ("1F441+FE0F+200D+1F5E8+FE0F", "eye_in_speech_bubble"),
]

# Skin-tone modifiers U+1F3FB..U+1F3FF. CLDR names a toned form
# "<base name>: <tone> skin tone"; the gemoji/enescakir alias scheme renders
# that as "<base_alias>_<tone>_skin_tone" (reference map construction:
# src/inference/emoji.go:27-40 over the full enescakir/emoji map, which
# includes every RGI tone variant). The RGI toned sequence is the base
# codepoint followed directly by the modifier — any FE0F of the untoned RGI
# form is dropped (UTS #51 §2.4).
_TONES = [
    ("\U0001F3FB", "light_skin_tone"),
    ("\U0001F3FC", "medium_light_skin_tone"),
    ("\U0001F3FD", "medium_skin_tone"),
    ("\U0001F3FE", "medium_dark_skin_tone"),
    ("\U0001F3FF", "dark_skin_tone"),
]

# Emoji_Modifier_Base codepoints (Unicode emoji-data.txt); inclusive ranges.
_EMB_RANGES = [
    (0x261D, 0x261D), (0x26F9, 0x26F9), (0x270A, 0x270D), (0x1F385, 0x1F385),
    (0x1F3C2, 0x1F3C4), (0x1F3C7, 0x1F3C7), (0x1F3CA, 0x1F3CC),
    (0x1F442, 0x1F443), (0x1F446, 0x1F450), (0x1F466, 0x1F469),
    (0x1F46B, 0x1F46E), (0x1F470, 0x1F478),  # excl. family & bunny ears
    (0x1F47C, 0x1F47C), (0x1F481, 0x1F483), (0x1F485, 0x1F487),
    (0x1F48F, 0x1F48F), (0x1F491, 0x1F491), (0x1F4AA, 0x1F4AA),
    (0x1F574, 0x1F575), (0x1F57A, 0x1F57A), (0x1F590, 0x1F590),
    (0x1F595, 0x1F596), (0x1F645, 0x1F647), (0x1F64B, 0x1F64F),
    (0x1F6A3, 0x1F6A3), (0x1F6B4, 0x1F6B6), (0x1F6C0, 0x1F6C0),
    (0x1F6CC, 0x1F6CC), (0x1F90C, 0x1F90C), (0x1F90F, 0x1F90F),
    (0x1F918, 0x1F91F), (0x1F926, 0x1F926), (0x1F930, 0x1F939),
    (0x1F93D, 0x1F93E), (0x1F977, 0x1F977), (0x1F9B5, 0x1F9B6),
    (0x1F9B8, 0x1F9B9), (0x1F9BB, 0x1F9BB), (0x1F9CD, 0x1F9CF),
    (0x1F9D1, 0x1F9DD), (0x1FAC3, 0x1FAC5), (0x1FAF0, 0x1FAF8),
]


def _is_modifier_base(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _EMB_RANGES)


# Keycap sequences: X + FE0F + U+20E3 COMBINING ENCLOSING KEYCAP. CLDR names
# them "keycap: X"; keycap_10 (U+1F51F) already lives in _SINGLES. The '#'
# and '*' aliases spell out the rune name (see PARITY.md — exact enescakir
# strings unverifiable offline).
_KEYCAPS = [
    ("#", "keycap_number_sign"), ("*", "keycap_asterisk"),
    ("0", "keycap_0"), ("1", "keycap_1"), ("2", "keycap_2"),
    ("3", "keycap_3"), ("4", "keycap_4"), ("5", "keycap_5"),
    ("6", "keycap_6"), ("7", "keycap_7"), ("8", "keycap_8"),
    ("9", "keycap_9"),
]

# Mixed-tone holding-hands ZWJ sequences (RGI since Emoji 12.0): the pair
# alias, the left and right person codepoints, joined by ZWJ + 1F91D
# (handshake) + ZWJ. Uniform tones use the single base + modifier and are
# generated by the _SINGLES tone loop.
_HOLDING_HANDS = [
    ("women_holding_hands", "\U0001F469", "\U0001F469"),
    ("woman_and_man_holding_hands", "\U0001F469", "\U0001F468"),
    ("men_holding_hands", "\U0001F468", "\U0001F468"),
]

# Tag-sequence subdivision flags (England/Scotland/Wales)
_TAG_FLAGS = [
    ("gbeng", "flag_for_england"),
    ("gbsct", "flag_for_scotland"),
    ("gbwls", "flag_for_wales"),
]

# Regional-indicator flags: ISO code → CLDR-name-derived alias suffix.
_REGIONS = """
ac ascension_island
ad andorra
ae united_arab_emirates
af afghanistan
ag antigua_barbuda
ai anguilla
al albania
am armenia
ao angola
aq antarctica
ar argentina
as american_samoa
at austria
au australia
aw aruba
ax aland_islands
az azerbaijan
ba bosnia_herzegovina
bb barbados
bd bangladesh
be belgium
bf burkina_faso
bg bulgaria
bh bahrain
bi burundi
bj benin
bl st_barthelemy
bm bermuda
bn brunei
bo bolivia
bq caribbean_netherlands
br brazil
bs bahamas
bt bhutan
bv bouvet_island
bw botswana
by belarus
bz belize
ca canada
cc cocos_keeling_islands
cd congo_kinshasa
cf central_african_republic
cg congo_brazzaville
ch switzerland
ci cote_divoire
ck cook_islands
cl chile
cm cameroon
cn china
co colombia
cp clipperton_island
cr costa_rica
cu cuba
cv cape_verde
cw curacao
cx christmas_island
cy cyprus
cz czechia
de germany
dg diego_garcia
dj djibouti
dk denmark
dm dominica
do dominican_republic
dz algeria
ea ceuta_melilla
ec ecuador
ee estonia
eg egypt
eh western_sahara
er eritrea
es spain
et ethiopia
eu european_union
fi finland
fj fiji
fk falkland_islands
fm micronesia
fo faroe_islands
fr france
ga gabon
gb united_kingdom
gd grenada
ge georgia
gf french_guiana
gg guernsey
gh ghana
gi gibraltar
gl greenland
gm gambia
gn guinea
gp guadeloupe
gq equatorial_guinea
gr greece
gs south_georgia_south_sandwich_islands
gt guatemala
gu guam
gw guinea_bissau
gy guyana
hk hong_kong_sar_china
hm heard_mcdonald_islands
hn honduras
hr croatia
ht haiti
hu hungary
ic canary_islands
id indonesia
ie ireland
il israel
im isle_of_man
in india
io british_indian_ocean_territory
iq iraq
ir iran
is iceland
it italy
je jersey
jm jamaica
jo jordan
jp japan
ke kenya
kg kyrgyzstan
kh cambodia
ki kiribati
km comoros
kn st_kitts_nevis
kp north_korea
kr south_korea
kw kuwait
ky cayman_islands
kz kazakhstan
la laos
lb lebanon
lc st_lucia
li liechtenstein
lk sri_lanka
lr liberia
ls lesotho
lt lithuania
lu luxembourg
lv latvia
ly libya
ma morocco
mc monaco
md moldova
me montenegro
mf st_martin
mg madagascar
mh marshall_islands
mk north_macedonia
ml mali
mm myanmar_burma
mn mongolia
mo macao_sar_china
mp northern_mariana_islands
mq martinique
mr mauritania
ms montserrat
mt malta
mu mauritius
mv maldives
mw malawi
mx mexico
my malaysia
mz mozambique
na namibia
nc new_caledonia
ne niger
nf norfolk_island
ng nigeria
ni nicaragua
nl netherlands
no norway
np nepal
nr nauru
nu niue
nz new_zealand
om oman
pa panama
pe peru
pf french_polynesia
pg papua_new_guinea
ph philippines
pk pakistan
pl poland
pm st_pierre_miquelon
pn pitcairn_islands
pr puerto_rico
ps palestinian_territories
pt portugal
pw palau
py paraguay
qa qatar
re reunion
ro romania
rs serbia
ru russia
rw rwanda
sa saudi_arabia
sb solomon_islands
sc seychelles
sd sudan
se sweden
sg singapore
sh st_helena
si slovenia
sj svalbard_jan_mayen
sk slovakia
sl sierra_leone
sm san_marino
sn senegal
so somalia
sr suriname
ss south_sudan
st sao_tome_principe
sv el_salvador
sx sint_maarten
sy syria
sz eswatini
ta tristan_da_cunha
tc turks_caicos_islands
td chad
tf french_southern_territories
tg togo
th thailand
tj tajikistan
tk tokelau
tl timor_leste
tm turkmenistan
tn tunisia
to tonga
tr turkey
tt trinidad_tobago
tv tuvalu
tw taiwan
tz tanzania
ua ukraine
ug uganda
um us_outlying_islands
un united_nations
us united_states
uy uruguay
uz uzbekistan
va vatican_city
vc st_vincent_grenadines
ve venezuela
vg british_virgin_islands
vi us_virgin_islands
vn vietnam
vu vanuatu
wf wallis_futuna
ws samoa
xk kosovo
ye yemen
yt mayotte
za south_africa
zm zambia
zw zimbabwe
"""

_ZWJ = "‍"
_VS16 = "️"
_FEMALE = "♀" + _VS16
_MALE = "♂" + _VS16


def _cps(spec: str) -> str:
    return "".join(chr(int(cp, 16)) for cp in spec.split("+"))


def _insert(table: Dict[str, str], emoji: str, alias: str) -> None:
    # reference tie-break: alphabetically first alias wins
    # (src/inference/emoji.go:31-37)
    existing = table.get(emoji)
    if existing is None or alias < existing:
        table[emoji] = alias


@lru_cache(maxsize=1)
def alias_table() -> Dict[str, str]:
    """emoji string → bare alias (no colons); exact-match keys."""
    t: Dict[str, str] = {}
    for line in _SINGLES.strip().splitlines():
        spec, alias = line.split()
        emoji = _cps(spec)
        _insert(t, emoji, alias)
        # RGI tone variants: base + modifier, FE0F (if any) dropped
        base = emoji.rstrip(_VS16)
        if len(base) == 1 and _is_modifier_base(base):
            for tone, tone_alias in _TONES:
                _insert(t, base + tone, f"{alias}_{tone_alias}")
    for base_spec, man_alias, woman_alias in _GENDERED:
        base = _cps(base_spec)
        _insert(t, base + _ZWJ + _MALE, man_alias)
        _insert(t, base + _ZWJ + _FEMALE, woman_alias)
        bare = base.rstrip(_VS16)
        if len(bare) == 1 and _is_modifier_base(bare):
            for tone, tone_alias in _TONES:
                _insert(t, bare + tone + _ZWJ + _MALE,
                        f"{man_alias}_{tone_alias}")
                _insert(t, bare + tone + _ZWJ + _FEMALE,
                        f"{woman_alias}_{tone_alias}")
    for obj_spec, role in _PROFESSIONS:
        obj = _cps(obj_spec)
        _insert(t, "\U0001F468" + _ZWJ + obj, "man_" + role)
        _insert(t, "\U0001F469" + _ZWJ + obj, "woman_" + role)
        for tone, tone_alias in _TONES:
            _insert(t, "\U0001F468" + tone + _ZWJ + obj,
                    f"man_{role}_{tone_alias}")
            _insert(t, "\U0001F469" + tone + _ZWJ + obj,
                    f"woman_{role}_{tone_alias}")
    for hair_spec, hair in _HAIR:
        h = _cps(hair_spec)
        _insert(t, "\U0001F468" + _ZWJ + h, "man_" + hair)
        _insert(t, "\U0001F469" + _ZWJ + h, "woman_" + hair)
        for tone, tone_alias in _TONES:
            _insert(t, "\U0001F468" + tone + _ZWJ + h,
                    f"man_{hair}_{tone_alias}")
            _insert(t, "\U0001F469" + tone + _ZWJ + h,
                    f"woman_{hair}_{tone_alias}")
    for pair_alias, left, right in _HOLDING_HANDS:
        for ltone, ltone_alias in _TONES:
            for rtone, rtone_alias in _TONES:
                if ltone == rtone:
                    continue  # uniform tone is the single base + modifier
                seq = (left + ltone + _ZWJ + "\U0001F91D" + _ZWJ
                       + right + rtone)
                _insert(t, seq, f"{pair_alias}_{ltone_alias}_{rtone_alias}")
    # people holding hands (1F9D1 pair): the base itself is a ZWJ sequence,
    # so ALL tone combinations are ZWJ forms — equal tones use the single
    # CLDR suffix ("people holding hands: medium skin tone"), mixed use both
    _insert(t, "\U0001F9D1" + _ZWJ + "\U0001F91D" + _ZWJ + "\U0001F9D1",
            "people_holding_hands")
    for ltone, ltone_alias in _TONES:
        for rtone, rtone_alias in _TONES:
            seq = ("\U0001F9D1" + ltone + _ZWJ + "\U0001F91D" + _ZWJ
                   + "\U0001F9D1" + rtone)
            suffix = (ltone_alias if ltone == rtone
                      else f"{ltone_alias}_{rtone_alias}")
            _insert(t, seq, f"people_holding_hands_{suffix}")
    for ch, alias in _KEYCAPS:
        _insert(t, ch + _VS16 + "\u20E3", alias)
    for parent_alias, parents in _PARENT_COMBOS:
        for child_alias, children in _CHILD_COMBOS:
            seq = _ZWJ.join(_cps(c) for c in parents + children)
            _insert(t, seq, f"family_{parent_alias}_{child_alias}")
    for spec, alias in _OTHER_ZWJ:
        _insert(t, _cps(spec), alias)
    for line in _REGIONS.strip().splitlines():
        code, name = line.split()
        flag = "".join(chr(0x1F1E6 + ord(c) - ord("a")) for c in code)
        _insert(t, flag, "flag_for_" + name)
    for tags, alias in _TAG_FLAGS:
        seq = "\U0001F3F4" + "".join(chr(0xE0000 + ord(c)) for c in tags) + "\U000E007F"
        _insert(t, seq, alias)
    return t


def lookup(seq: str) -> Optional[str]:
    """``:alias:`` for an exact-match emoji sequence, else None."""
    alias = alias_table().get(seq)
    return f":{alias}:" if alias is not None else None
